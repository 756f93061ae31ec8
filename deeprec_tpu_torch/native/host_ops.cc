// Host-side ops of the PyTorch port: the Criteo TSV parser of the input
// pipeline and the id hash of the host spill tier's index.
//
// Copy of the JAX package's deeprec_tpu/native/host_ops.cc parser half
// (mix64, parse_float, parse_cat_token, drt_parse_criteo) and drt_hash64,
// kept here so the port builds its own library and imports nothing of the
// JAX package. The arithmetic is the same line for line, so both parse a
// file to the same bits and hash an id to the same value. Plain C ABI,
// bound through ctypes; every buffer is caller-allocated.

#include <cstdint>
#include <cstring>

extern "C" {

// splitmix64 finalizer.
static inline uint64_t mix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// mix64 of each id XOR salt (the host index's probe start,
// embedding/multi_tier.py).
void drt_hash64(const int64_t* in, int64_t n, uint64_t salt, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = (int64_t)mix64((uint64_t)in[i] ^ salt);
  }
}

// Criteo-Kaggle TSV: label \t I1..I13 \t C1..C26 (hex). A missing
// numeric reads 0; with log_transform the ints become
// sign(x) * log1p(|x|). A categorical token parses as hex (a token with
// any other character is string-hashed), masked to 40 bits and offset
// by (field << 40); an empty token is id 0 of its field. Returns the
// rows parsed (<= max_rows); consumed gets the bytes of whole lines
// parsed, so a caller re-feeds a partial tail with the next chunk.

static inline double parse_float(const char* s, const char* e) {
  // Sign, integral part, fraction; Criteo ints have no exponent.
  if (s >= e) return 0.0;
  bool neg = false;
  if (*s == '-') { neg = true; ++s; }
  double v = 0.0;
  while (s < e && *s >= '0' && *s <= '9') v = v * 10.0 + (*s++ - '0');
  if (s < e && *s == '.') {
    ++s;
    double f = 0.1;
    while (s < e && *s >= '0' && *s <= '9') { v += (*s++ - '0') * f; f *= 0.1; }
  }
  return neg ? -v : v;
}

static inline int64_t parse_cat_token(const char* s, const char* e) {
  const uint64_t kMask40 = (1ull << 40) - 1;
  uint64_t v = 0;
  const char* p = s;
  for (; p < e; ++p) {
    const char c = *p;
    uint64_t d;
    if (c >= '0' && c <= '9') d = (uint64_t)(c - '0');
    else if (c >= 'a' && c <= 'f') d = (uint64_t)(c - 'a' + 10);
    else if (c >= 'A' && c <= 'F') d = (uint64_t)(c - 'A' + 10);
    else break;
    v = (v << 4) | d;
  }
  if (p == e) return (int64_t)(v & kMask40);
  uint64_t h = 0xCBF29CE484222325ull;
  for (p = s; p < e; ++p) h = (h ^ (uint8_t)*p) * 0x100000001B3ull;
  return (int64_t)(mix64(h) & kMask40);
}

int64_t drt_parse_criteo(const char* buf, int64_t len, int64_t max_rows,
                         int log_transform, float* labels, float* dense13,
                         int64_t* cats26, int64_t* consumed) {
  const int kInt = 13, kCat = 26;
  int64_t row = 0;
  const char* p = buf;
  const char* end = buf + len;
  const char* line_start = p;
  while (row < max_rows && p < end) {
    const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
    const char* le = nl ? nl : end;
    if (!nl && consumed) break;  // partial tail: the caller re-feeds it
    const char* f = line_start;
    const char* t = (const char*)memchr(f, '\t', (size_t)(le - f));
    const char* fe = t ? t : le;
    labels[row] = (float)parse_float(f, fe);
    f = t ? t + 1 : le;
    for (int i = 0; i < kInt; ++i) {
      t = f < le ? (const char*)memchr(f, '\t', (size_t)(le - f)) : nullptr;
      fe = t ? t : le;
      double v = parse_float(f, fe);
      if (log_transform) {
        double a = v < 0 ? -v : v;
        double lg = a > 0 ? __builtin_log1p(a) : 0.0;
        v = v < 0 ? -lg : lg;
      }
      dense13[row * kInt + i] = (float)v;
      f = t ? t + 1 : le;
    }
    for (int i = 0; i < kCat; ++i) {
      t = f < le ? (const char*)memchr(f, '\t', (size_t)(le - f)) : nullptr;
      fe = t ? t : le;
      int64_t h = (f < fe) ? parse_cat_token(f, fe) : 0;
      cats26[row * kCat + i] = h + ((int64_t)i << 40);
      f = t ? t + 1 : le;
    }
    ++row;
    p = nl ? nl + 1 : end;
    line_start = p;
  }
  if (consumed) *consumed = (int64_t)(line_start - buf);
  return row;
}

}  // extern "C"
