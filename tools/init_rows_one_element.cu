// One element of the fresh-row draw (P2, deeprec_tpu_torch/csrc/
// init_rows.cu) in a kernel of its own, one kernel per initializer, so
// that the instructions an element takes can be read from the SASS
// (`cuobjdump -sass`). chip_smoke.py builds it with the flags of
// init_rows (build.py) and counts each kernel's instructions up to its
// first EXIT: the path an element takes when no special case of logf,
// cosf or sqrtf is hit (their slow paths sit behind branches).

#include "../deeprec_tpu_torch/csrc/init_rows.cu"

template <int kKind>
__global__ void draw_one(float* out, uint32_t base, uint32_t col, float a,
                         float b, uint32_t mix1, uint32_t mix2) {
  *out = draw<kKind>(base, col, a, b, mix1, mix2);
}

template __global__ void draw_one<kZeros>(float*, uint32_t, uint32_t, float,
                                          float, uint32_t, uint32_t);
template __global__ void draw_one<kConstant>(float*, uint32_t, uint32_t,
                                             float, float, uint32_t,
                                             uint32_t);
template __global__ void draw_one<kUniform>(float*, uint32_t, uint32_t, float,
                                            float, uint32_t, uint32_t);
template __global__ void draw_one<kNormal>(float*, uint32_t, uint32_t, float,
                                           float, uint32_t, uint32_t);
template __global__ void draw_one<kTruncatedNormal>(float*, uint32_t,
                                                    uint32_t, float, float,
                                                    uint32_t, uint32_t);
