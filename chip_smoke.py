#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
NVIDIA card (Hopper: the kernels build for ``sm_90a``) and ``nvcc``.

Phases, one output line or more each; any failure raises and exits
non-zero:

1. device: the card's name and power limit (nvidia-smi); TF32 off.
2. build: the ``gather_rows``, ``sparse_apply``, ``hash_probe`` and
   ``init_rows`` kernels from ``deeprec_tpu_torch/csrc``
   (``build.KERNELS``), one ``nvcc`` each, in parallel; beside them
   ``tools/init_rows_one_element.cu``, whose SASS gives the
   instructions an element of P2's draw takes at least (the shortest
   path through it; P2's arithmetic bound:
   instructions x elements over the SMs' issue rate, 4 schedulers of
   32 lanes an SM at the card's maximum SM clock).
3. K1 against its plain PyTorch version on the card, exact (a gather is
   a copy), at the serving shapes with uniform slots and at edge cases
   (``EDGE_WIDTHS``, bf16 at odd D, n below a warp, ragged and empty,
   the last row read); device times of both (``median_ms``), and of
   ``torch.nn.functional.embedding`` on the clamped slots (the library
   call for a plain gather).
4. serving state at reference shapes: the headline WDL (two coalesced
   tables, 129 x 4,194,305 and 65 x 524,289 float32) filled with the
   distinct ids of 32 synthetic Criteo batches of 16,384, rows drawn as
   a fresh insert draws them, towers from a seeded generator; saved as a
   full checkpoint.
5. in-process serving: ``ServingModel.full_update`` restores it and
   scores a 16,384 batch through K1 and P1's ``find`` (launch counts
   reset just before, read just after), against the same state scored
   with the plain gather, and against a CPU restore of the checkpoint on
   a small input. Then K1 and P1 on that request's own lookup operands,
   both tables: equal to their plain versions, timed beside them and
   ``F.embedding``; and the request's lookups under
   ``torch.cuda.set_sync_debug_mode("error")``.
6. the worker process: spawned, queried over HTTP, its answers checked
   against phase 5's scores, shut down by closing its stdin.
7. (a) K2 (sparse Adagrad) and K3 (lazy Adam) against their plain
   versions at the headline shapes, with dropped slots, filtered rows
   and fresh rows, and at edge cases (``EDGE_WIDTHS``, n below a warp,
   ragged and empty, update shares of none, one row per 32, ~26 % and
   all, the last writable row updated); device times. An apply's bound
   counts what its rows need: a fresh row's slot rows are not read
   (``_apply_bytes``).
8. (b) the headline training step through ``deeprec_tpu_torch.bench``:
   30 warm-up and 30 measured steps at B = 16,384 (samples/s, per-step
   ``n_overflow``, finite losses), with K1, K2, P1 and P2 launch counts
   reset just before and read just after. The lookups of an unseen
   batch (``unseen_batch``: every id moved past the stream's) run under
   ``set_sync_debug_mode("error")``, and those of another are captured
   in a CUDA graph, which fails on any host sync; P2 is compared and
   timed on the draws of a third (every row fresh). Then one more
   step's lookup runs with K1's, P1's and P2's operands recorded, and
   each is compared and timed on them, both tables, as in phase 5 (P1
   on the stream's next batch, fast round and straggler kernel apart,
   and on the same batch again, every key then present); that step's
   row gradients, taken once, are applied by K2 to one copy of the
   tables and by the plain version to another, compared, and both
   timed, beside ``torch.optim.Adagrad`` on the same rows as a sparse
   COO gradient (eps 0: the same update up to rounding, fresh rows'
   accumulators being at their initial value). P1's lines give the
   rounds the kernel ran beside the plain version's; P2's the share of
   its byte bound and of its arithmetic bound. The kernels' record
   takes K1's, K2's, P1's and P2's times from here.
9. (d) that trained state saved as a full checkpoint and restored with
   the port's ``CheckpointManager``: equal eval scores, and the
   checkpoint holds ``slot/['accum']`` rows and ``dense_opt`` leaves.
10. (c) the same path with ``sparse_opt="adam"`` for a few steps, with
   the same checks for K1, P1, P2 and K3 (beside
   ``torch.optim.SparseAdam``, its step size set to the step's alpha).
11. (e) the sizes of ``__graft_entry__._build`` built with the port
   alone, three steps on the card and on the CPU from the same weights;
   the losses must agree.
12. (f) the static-bucket row (``bench.build_wdl(static_buckets=
   True)``: two offset-coalesced matrices, 1,700,001 x 129 and 94,491 x
   65): 30 warm-up and 30 measured steps with K1 and K2 launch counts
   reset just before and read just after, then K1 and K2 against their
   plain versions on one more step's own operands (no row is ever
   fresh), timed; a 512-row request scored from the trained state
   through K1 and through the plain gather (identical logits); a full
   checkpoint saved and restored into fresh tables (rows and
   accumulators equal) and served by ``ServingModel`` (identical
   logits).
13. (g) the dim16 row (one coalesced EV table, 17 x 2**25 rows): 10
   warm-up and 10 measured steps, launch counts as in (b), K1, P1, P2 and
   K2 at D = 17 against their plain versions on a step's operands.
14. (h) the e2e row: a TSV of 8 x 16,384 rows written to a temporary
   directory; its first 1,000 lines parsed by the native parser and by
   the Python line parser (labels and ids equal, numerics within one
   float32 ulp: the Python parser takes log1p in float32, the C++ one
   in double, as in the JAX package); the first batch's compact pack
   unpacked on the card equal to the full pack; then the pipeline
   (native parse, compact pack on a prefetch thread, pinned copies,
   headline step) timed with launch counts as in (b), the lookups of one
   of its batches under ``set_sync_debug_mode("error")``, and K1, P1, P2
   and K2 compared on another.
15. (i) run right after phase 7: P1 against its plain version on every
   case of ``tests/torch_probe_cases.py`` (the CPU tests' cases:
   duplicates, one crowded bucket row, more ids pending than a round
   takes, the round cap, tombstones, lookup-only ids, sentinels), then
   on a 65-wide table of 2**19 slots fed batches of 294,912 unseen ids
   until it is full (or FULL_TABLE_BATCHES were fed), timed on the
   next batch (almost no id finds a free slot: the plain version runs
   to the round cap, the kernel stops at the first round whose ids are
   all dead) and on a lookup of it; then an insert of unseen ids into
   that table captured in a CUDA graph (no host sync).
16. (j) the headline path for 3 + 3 steps with each optimizer beyond
   Adagrad and Adam (SGD, AdagradDecay, AdamAsync in both forms, Ftrl,
   FtrlV2): P1 launched by each, K3 by AdamAsync.
17. (k) a reading, not a gate: the headline model trained twice from the
   same state on the same 5 batches; whether losses and tables are
   bit-equal, and by how much they differ.
18. (l) the fused combine (``combine_tables`` + ``apply_fn_fused``)
   against the dict path for 3 headline steps on those batches: losses
   within ``FUSED_LOSS_RTOL``; then the step time of each, in turns on
   the same batches.

19. (m) the WDL ``--ev`` run (``ev_cbf``): ``tools/train_zoo_torch.py
   wdl --bf16 --ev --cbf --filter_freq 2 --steps_to_live 3`` at B =
   16,384 and full width (three coalesced tables, 128 x 2,097,152, 64 x
   524,288 and 1 x 4,194,304, each with 2**20 CBF counters), 8 steps
   with saves (incremental every 2, full at 6 after a shrink), eval, then
   a second run resumed from its end-of-run save to 10 steps, through
   ``main`` in this process: K1, K2, P1 (insert and find) and P2 launch
   counts reset just before and read just after; finite losses and an
   AUC strictly between 0 and 1. Then the same model through the
   Estimator and a CheckpointManager: the CBF step timed (ms, samples/s),
   a shrink and a full save at step 6, steps to 8, a shrink and an
   incremental save carrying tombstones (shrink ms, keys evicted, save
   seconds); a fresh restore (full-6, incr-8 with its tombstones
   replayed) equal to the live state key by key (rows, freqs, versions,
   counters); a ServingModel at full-6 whose ``delta_update`` drops a
   key evicted at 8 (P1 compared on the replay's probes); K1, K2, P1 and
   P2 on the next step's operands (tables with tombstones) and P1's find
   on the eval lookups, against their plain versions; the CBF step's
   lookups under ``set_sync_debug_mode("error")`` and captured in a CUDA
   graph; ``dedup``'s device time against ``lookup_train_occ``'s claim
   dedup on the same ids.

20. (n) ``epoch``: the headline model (B = 16,384, full width) trained
   on a pool of 8 pre-packed batches for 2 epochs twice from one state:
   by the eager loop and by ``make_epoch_step`` (step 0 eager, then the
   step captured once in a CUDA graph and replayed, under
   ``set_sync_debug_mode("error")``); losses ``[2, 8]`` and every state
   tensor (tables, accumulators, key rows, metadata, dense params and
   their state) bit-equal, else the first differing tensor is named.
   The eager loop's median synchronized step, the replays' device ms a
   step (CUDA events) and the host's enqueue ms a step. K1, K2, P1 and
   P2 launch counts reset just before the captured call and read just
   after (step 0 and the capture; each replay relaunches what was
   captured). A ``micro_batch_num=4`` step from a copy of the trained
   state against the full-batch step (loss rtol 1e-5; tables and dense
   params rtol 1e-4, atol 1e-6, as ``tests/test_train_features.py``;
   ``n_overflow`` 0), then both timed over 5 more steps in turns. Each
   kernel against its plain version on the operands of the epoch's
   first step (the pool's first batch on the state it started from), as
   in phase 8. Then ``SparseAdam`` (K3) with dense Adam for a pool of
   4, one epoch, eager against captured, bit-equal (the beta powers and
   Adam's count advance at every replay), K3 against its plain version.
   Last, ``tools/train_wdl_torch.py 16 --pool 8`` at full width in this
   process: finite losses, 0 < AUC < 1.

21. (o) ``zoo``: every model of the registry (wdl, deepfm, dlrm and
   dlrm ``--interaction_op cat``, din, dien, bst, dssm, esmm, mmoe, dbmtl,
   simple_multitask) through ``tools/train_zoo_torch.main`` in this
   process at full width (its ``COLUMN_KWARGS``/``MODULE_KWARGS``:
   DeepFM 16 x 2,097,152 and 1 x 2,097,152; DLRM 16 x 524,288; DIN and
   DIEN one 18-wide table of 1,048,576 rows holding ``user``,
   ``item_emb`` and ``cat_emb``), ``--bf16``, B = 4,096, 12 steps and 2
   eval batches: K1, K2, P1 and P2 launch counts reset just before each
   run and read just after, each above 0; finite losses, 0 < AUC < 1 for
   the single-logit models. Then each model in process: the median
   synchronized step of 5 after 2 (ms, samples/s); one step under
   ``set_sync_debug_mode("error")``; the eval embeddings of a batch's
   first ``ZOO_CPU_ROWS`` rows and the dense params through the model on
   the card and on the CPU (within ``ZOO_CPU_ATOL``). DIN: the tool run
   to 6 steps with ``--checkpoint`` and resumed to 9, and the in-process
   state saved and restored key by key. On DIN's and DeepFM's first step
   (every row fresh), K1, K2, P1 (insert, then the same batch again,
   every key present; and the eval lookups' find) and P2 against their
   plain versions, timed beside their bounds and library calls
   (``_compare_step_kernels``), the records under the ``zoo/din`` and
   ``zoo/deepfm`` paths.

22. (p) the zoo's captured epochs and the measuring tools: each of the
   12 runs of phase 21 at full width, B = 4,096, built by
   ``tools/train_zoo_torch.build``, trained on a pool of 4 batches for 2
   epochs twice from one state, by the eager loop and by
   ``make_epoch_step`` captured (``eager_vs_graph``, as phase 20 holds
   the headline): losses and every state tensor bit-equal; K1, K2, P1
   and P2 launch counts reset just before each captured call and read
   just after, each above 0; the replays' device ms a step beside the
   eager median. The kernels' record of the ``zoo_epoch`` path sums
   those launches and takes its times from phase 21's DIN first step,
   which the captured DIN epoch's first step repeats. Then each tool
   once, in this process: ``tools/zoo_auc_torch.py``'s DIN for 3
   epochs of 4 batches, bf16 and fp32 (``ZOO_AUC.json``'s keys, 0 < AUC
   < 1, the card's reserved memory level from the second epoch on),
   merged by ``tools/zoo_delta_torch.py``; ``model_benchmark_torch``'s
   DeepFM (short warm-up and measured runs; 0 < mfu < 1 where
   ``CHIP_PEAKS`` names the card) written by
   ``write_bench_zoo_torch``; ``serving_benchmark_torch`` at 1 and 512
   rows; ``step_breakdown_torch --cap 17`` (its phases sum to within
   a factor 2 of the full step); every job of
   ``kernel_benchmark_torch`` at its shapes, each kernel held against
   its plain version, timed beside its bound and library call (the
   ``kernel_benchmark/JOB`` records count the launches of the job's
   checks and timed captures); ``env_collect_torch``.

23. (q) ``sharded``: the headline WDL with its tables row-sharded over a
   ``torch.distributed`` mesh (``embedding/sharded.py``), in ranks
   spawned by ``torch.multiprocessing.spawn`` (a rank that raises fails
   the script). (a) One rank a visible card over NCCL (one rank on a
   one-card machine, whose all-to-alls send to itself), every table
   sharded; (b) two gloo ranks sharing the card, the 65-wide table
   replicated. Each rank: B = 16,384, ``SHARDED_STEPS`` steps of
   ``SparseAdagrad(0.05)`` against the unsharded headline trained on the
   same global batches on its card (losses within ``SHARDED_LOSS_RTOL``;
   the keys its shards own, exactly; their rows key by key within
   ``SHARDED_ROW_TOL``); ``n_overflow`` 0; K1, K2, P1 and P2 launch
   counts reset just before the steps and read just after, each above
   0; the ms of each step between CUDA events beside the unsharded
   step's, no host sync in the last step (the sync debug mode's
   warnings; gloo's own threads sync outside it), and in the one before it
   each all-to-all, all-gather and all-reduce (bytes sent, ms between
   CUDA events); the sharded eval of the next batch against the
   unsharded eval (``SHARDED_LOGIT_ATOL``); a sharded checkpoint saved
   and restored unsharded: the same keys and rows, and its eval logits.
   In (a), K1, K2, P1 and P2 on the owner side of one more sharded
   step's lookups and gradients, each against its plain version and
   timed (the ``sharded`` records; gloo's ranks share the card, so (b)
   times nothing but its steps).

24. (r) ``table_variants``: the zoo's WDL at full width (its 26 deep
   columns 64 or 128 wide and 26 wide ones, capacity ceiling 2**18), B =
   4,096, bf16 towers over float32 params. (a) ``tools/train_zoo_torch
   .main(["wdl", "--adaptive_emb", ...])`` for 12 steps and 2 eval
   batches with ``--checkpoint`` (52 adaptive tables: they bypass
   coalescing; static tables of 2**14 buckets among the dense params):
   K1, K2, P1 (insert, find) and P2 launch counts reset just before and
   read just after; the ids gone hot each step (a fresh row among them
   takes its seed at once); finite loss, 0 < AUC < 1; the end-of-run
   save restored and served by ``ServingModel`` on 3 requests, bit-equal
   to ``make_eval_step`` on the restored and on the live state; then
   steps in process (ms, samples/s, one under
   ``set_sync_debug_mode("error")``) and each kernel on a step's
   operands against its plain version (K2 updating the migrated seeds
   from the lookup's rows), the ``VARIANT_LIMIT`` calls of largest
   operands of each. (b) That model through ``make_epoch_step``, eager
   against captured, bit-equal, 0 host syncs. (c) The deep columns as
   dynamic-dimension columns (4 blocks unlocking at
   ``VARIANT_THRESHOLDS``, masked) under ``SparseAdagrad`` (K2) and
   ``SparseAdam`` (K3): steps timed with launch counts reset just
   before and read just after, the share of keys past each threshold,
   the kernels on a step's operands (masked rows, fresh rows among
   them). (d) The same with each deep column's hot sibling at capacity
   / 16: ``memory_rows`` against ``capacity * dim``. (e) A
   ``TensibleEV`` grown once on the card: every row, freq and
   accumulator survives, P1 finds every key of the regrown table (its
   re-inserts and the find against the plain version). (f) One NCCL rank
   a card of (a)'s and (d)'s models on a mesh against the unsharded
   models on the same global batches (phase 23's tolerances; whether
   bit-equal is logged).

25. (s) ``tiered``: multi-tier storage (``embedding/multi_tier.py``) on
   the headline WDL at full width (``bench.build_wdl(storage=...)``: both
   coalesced tables ``HBM_HOST``, so they record freq and version), fed
   unseen batches of the e2e row's vocabulary (``TIER_VOCAB``), the
   ``TieredGroup``'s ``pre_step`` taking each raw batch (its ids stay on
   the host). (a) ``TIER_STEPS`` batches, then the first ``TIER_REFEED``
   again, at watermarks 0.85 / 0.70, a demotion check every 4 steps: per
   step the loss, ``n_overflow``, each table's promoted, demoted and
   spill rows, and of ``pre_step``, the step and ``post_step`` the ms
   between CUDA events, the host's wall ms and the host syncs (the sync
   debug mode's warnings); beside it the same batches without tiers
   (``n_overflow``). K1, K2, P1 (insert, find) and P2 launch counts
   reset just before the tiered run and read just after, each above 0.
   The round-trip gate (``_RoundTrip``): the rows of a table's first
   demotion (values, freqs, versions, accumulators), each checked on the
   card on its first promotion, bit for bit, ``TIER_GATE_KEYS`` or more.
   (c) A full save of that state with its spill files, restored into
   fresh tables and a fresh tiered group: tables and spill stores equal
   key by key, bit for bit. Then one more ``pre_step`` (of the re-fed
   batch whose ids the tiers hold most of) and its step, with P1's
   insert of the promotion into the just-demoted table, P1's find of the
   resident check, K1's fetch, K2's apply and P2 against their plain
   versions and timed (the ``tiered`` and ``tiered/promotion`` records).
   (b) The 65-wide table on three tiers (``HBM_HOST_DISK``,
   ``TIER_HOST_CAPACITY`` rows of host RAM, the disk tier in a new
   directory under ``$TMPDIR``, removed after): the same gate, with rows
   back from disk. (d) ``SparseAdam``: the gate over m and v, K3 on the
   promoted rows (``tiered/adam``). (e) One NCCL rank (S = 1) of the
   tiered headline trained on a mesh on the headline's own stream, its
   ``TieredGroup``'s mesh branch (the all-gather) held at every
   ``pre_step`` and ``post_step`` against the unsharded branch on a copy
   of the same state: tables, slot rows, spill stores and tier stats
   bit-equal; the ``pre_step`` all-gathers counted.

26. (t) ``serving_rest``, run right after phase 6 on phase 4's headline
   checkpoint (129 x 4,194,305 and 65 x 524,289 float32, 614,373 keys;
   1024/512/256 bf16 towers). (a) ``ServingModel.warmup`` on 2 requests
   of 512 rows (seconds; the version unchanged), then 4 requests of 512
   rows through the KServe v2 front (``serving/kserve.py``) over HTTP,
   K1 and P1 ``find`` launch counts reset just before and read just
   after; each response's scores bit-equal to the sigmoid of
   ``ServingModel.predict`` on the same rows; K1 and P1 on a request's
   own operands against their plain versions, timed (the
   ``serving_kserve`` records). (b) The port's C ABI
   (``serving/native/processor.cc``, built with ``g++``): ``initialize``
   spawns the worker on the card (seconds: start, restore, kernel load);
   ``process`` and ``batch_process`` of 64 rows and the C SDK
   (``serving/sdk/c``, built with ``gcc``) against the same worker agree
   with phase 5's scores within ``PROB_ATOL``; ``process`` latency at 1
   and 64 rows; the worker's own K1 and P1 ``find`` launches (its
   responses carry them: ``wdl_entry``'s ``report_launches``), the
   kernels held on the same request's operands in this process
   (``serving_abi``). (d) ``ServingModel(mesh=)`` in spawned ranks: one
   NCCL rank a card (phase 5's batch; its logits against phase 5's, bit
   for bit expected, within ``SHARDED_LOGIT_ATOL``; K1 and P1 on the
   owner side against their plain versions: ``serving_mesh``), then two
   gloo ranks on card 0, each on half the batch, their logits
   concatenated within ``SHARDED_LOGIT_ATOL``. (e) Both tables quantized
   per row to int8 (``tools/low_precision.py``), scored through
   ``gather_quantized``: table bytes, ``accuracy_delta``'s AUC on 4
   batches of 16,384, the int8 and bf16-kernel logit differences. (c)
   Last, as it rewrites rows: the whole model published into an
   ``InMemoryFeatureStore`` and scored by ``RemoteServingModel`` (512
   rows, within ``REMOTE_LOGIT_ATOL`` of ``ServingModel``); the rows a
   request reads rewritten at a new version, that delta published into
   the port's ``MiniRedisServer`` and scored, with and without the
   cache; publish seconds and rows.

27. (u) ``input_and_mesh_epoch``, last. (a) Online learning from Kafka
   at full width: the headline (``bench.build_wdl``) trained on
   ``KAFKA_BATCHES`` batches of 16,384 TSV lines of its own stream
   (``SyntheticCriteo(vocab=CRITEO_HASH_BUCKETS, seed=0)``, written to a
   temporary directory by ``bench.write_tsv``), produced into the port's ``MiniKafkaBroker`` on loopback
   (one partition) and consumed by ``data/kafka.KafkaDataset``, whose
   ``parse`` runs the native parser and ``batch_np_dict`` and packs the
   batch onto the card: losses and every state tensor bit-equal to the
   same lines through ``criteo_file_batches``, ``n_overflow`` 0; K1,
   K2, P1 (insert) and P2 launch counts reset just before the Kafka run
   and read just after, each above 0; the host ms of each batch's poll,
   parse and pack beside the step's ms between CUDA events. Then a run
   stopped after ``KAFKA_STOP`` batches, its ``state()`` restored into
   a new ``KafkaDataset`` and run on: bit-equal to the run without the
   stop. Then ``KAFKA_E2E_BATCHES`` batches of the e2e row's stream
   (``SyntheticCriteo(vocab=200_000, seed=7)``) through another topic,
   bit-equal to the same lines from a file, each step's ``n_overflow``
   equal on both sides (that vocabulary overflows the unique budgets).
   The kernels against their plain versions on the first Kafka
   batch's operands, from the state the runs started at (the
   ``online_kafka`` records). (b) One NCCL rank (S = 1, spawned) of
   phase 23 (a)'s sharded headline by ``make_epoch_step(mesh=)`` on a
   pool of ``MESH_EPOCH_POOL`` batches for ``MESH_EPOCH_EPOCHS``
   epochs: step 0 eager, then the step with its all-to-alls and
   all-reduces captured in one CUDA graph and replayed under
   ``set_sync_debug_mode("error")``; losses and every state tensor
   bit-equal to ``make_train_step(mesh=)`` stepped over the same pool
   from the same state; ``captured`` True and E * K - 1 replays; the
   collectives the capture holds (from ``Mesh.trace``: the same as step
   0's); the device ms a replay beside the stepped loop's synchronized
   step; launch counts around the captured call as in (a); the kernels
   on the epoch's first step's operands (``sharded_epoch``). (c) In the
   same rank, ``tools/scaling_model_torch.anchor_run``: the sharded and
   the unsharded headline steps on the same global batches (ms between
   CUDA events), the traced all-to-all and all-reduce bytes of a step
   against the byte model's; a difference fails the phase.

28. (v) ``occ_combine``, run right after phase 7: the embedding combine
   and its backward (``ops/kernels/occ_combine.py``, the ``occ_``
   kernels of ``csrc/occ_combine.cu``) against the plain version at the
   benchmark cells' shapes: DLRM's one table (B = 6,912, 26 columns of
   one summed id at dim 128) and WDL's two (B = 16,384; 8 columns at 129
   and 18 at 65, mean), on Zipf(1.2) ids folded by each column's
   vocabulary (``benchmark/configs``), and on one row of 20,000
   occurrences. The outputs and the rows' gradient bit for bit (every
   scale is 1: the same sums in the same order); the rows no real
   occurrence reads, the rows split off to the long-segment blocks
   (``<table>/grad_split_rows``) and the longest row's occurrences. The
   device times of the forward and of forward and backward
   (``median_ms``), of the plain version (the same expressions under
   autograd, captured), and, as the yardstick the port no longer calls,
   those expressions timed between events (``event_ms``); the bound of
   each direction: every distinct row read and every output row written
   once forward, with 17 bytes an occurrence of index, mask, scale and
   sort key; every output gradient read and every row gradient written
   once backward, with 16 bytes an occurrence of sorted key, its
   occurrence and scale (the backward's time holds the stable
   ``torch.sort`` of the keys). The records' launches are those of the
   headline training path (phase 8 (b)), which combines through the
   group's ``occ_combine``; its launch check, like those of the e2e and
   ev_cbf paths, fails where it launched none.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 16384
INSERT_BATCHES = 32
REPS = 20
GRAPH_CALLS = 10  # calls of a timed function per captured CUDA graph
# Card vs CPU logits on the same state: bf16 GEMMs round differently on
# the two devices. About 10x the reading of two runs on an H100 (max abs
# diff 1.878e-4 in both).
CPU_LOGIT_ATOL = 2e-3
# Worker vs in-process scores for the same rows: the GEMMs run at other
# batch sizes (other cuBLAS kernels), so bf16 rounding may differ. About
# 10x the reading of two runs on an H100 (max abs diff 1.376e-4 and
# 1.422e-4 in each, at 512 rows).
PROB_ATOL = 1.5e-3
SMALL = 256  # rows of the CPU reference check
HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak device-memory rate
# Lane instructions an SM issues a cycle: 4 schedulers, a warp of 32 each.
LANES_PER_SM_CYCLE = 4 * 32
# Filled in phases 1-2: the SMs and maximum SM clock of the card, and
# the SASS instructions an element of P2's draw takes, by initializer.
CARD = {}
DRAW_INSTRUCTIONS = {}
# Kernel vs plain optimizer apply on the same inputs: the kernels are
# built with --fmad=false and repeat the plain version's operations, so
# the slot arrays (accumulator, moments) must be equal; the table rows
# may differ in the last bits where rsqrtf and PyTorch's rsqrt differ.
APPLY_RTOL, APPLY_ATOL = 1e-6, 1e-7
ADAM_STEPS = (2, 3)  # warm-up and measured steps of phase (c)
DIM16_STEPS = (10, 10)  # warm-up and measured steps of phase (g)
E2E_BATCHES = 8  # batches of the TSV of phase (h)
FULL_TABLE_BATCHES = 8  # unseen-id batches at most to fill phase (i)'s table
OPT_STEPS = (3, 3)  # warm-up and measured steps of phase (j)
REPEAT_STEPS = 5  # steps of each run of phase (k)
FUSED_STEPS = 3  # steps of phase (l)
# Fused vs dict path losses on the card: the same forward on the same
# embeddings, split from the tables' occurrences instead of combined per
# column. Bit-equal in the reading on an H100 (3 steps), as were
# two runs of the dict path (phase (k)); the bound leaves a few float32
# ulps for a GEMM that picks another algorithm.
FUSED_LOSS_RTOL = 1e-6
# P2 vs its plain version, normal initializers: the same float32
# operations in the same order, logf/cosf/sqrtf on both sides; the bound
# leaves two float32 ulps at |z| = 2 (times the scale).
INIT_ATOL = 5e-7
FUSED_TIMED_STEPS = (3, 10)  # warm-up and timed steps of each run in (l)
# Card vs CPU loss of the small float32 config over three steps: GEMM
# sums and the atomics of the rows' backward run in another order.
# About 17x the reading on an H100 (max abs diff 5.96e-8, both
# optimizers).
SMALL_LOSS_ATOL = 1e-6
# Row widths of the kernels' edge cases: below, at and one above
# multiples of the 32 lanes of a warp.
EDGE_WIDTHS = (1, 4, 17, 64, 65, 128, 129, 256, 257)
# Phase 19 (m): the WDL --ev run of tools/train_zoo_torch.py at full
# width (three tables, 128 x 2,097,152, 64 x 524,288 and 1 x 4,194,304,
# CBF counters and eviction on every column; the save at step 6 evicts
# keys untouched since step 2), and the in-process run's warm-up and
# timed steps.
EV_CBF_ARGS = ["wdl", "--batch_size", str(BATCH), "--bf16", "--ev", "--cbf",
               "--filter_freq", "2", "--steps_to_live", "3", "--save_steps",
               "6", "--incremental_ckpt", "2", "--eval_steps", "4",
               "--log_steps", "4"]
EV_CBF_STEPS = (2, 4)
# Phase 20 (n): pool size and epochs of the captured headline run, the
# pool of its Adam run (one epoch), the micro-batches of its micro-batch
# step with that step's tolerances against the full batch
# (tests/test_train_features.py:48-56), and the cut-down tool run.
EPOCH_POOL, EPOCH_EPOCHS = 8, 2
EPOCH_ADAM_POOL = 4
MICRO_BATCHES = 4
MICRO_LOSS_RTOL = 1e-5
MICRO_RTOL, MICRO_ATOL = 1e-4, 1e-6
MICRO_TIMED_STEPS = 5
TRAIN_WDL_ARGS = ["16", "--pool", "8"]
# Phase 21 (o): every model of the zoo through tools/train_zoo_torch.py
# at full width (its COLUMN_KWARGS / MODULE_KWARGS), and DLRM's cat
# interaction; the in-process run's warm-up and timed steps; the rows of
# the card-vs-CPU forward; DIN's save and resume steps; the models whose
# step operands the kernels are held on (DIN's 18-wide sequence table,
# DeepFM's 16-wide and 1-wide tables).
ZOO_RUNS = (("wdl",), ("deepfm",), ("dlrm",), ("dlrm", "--interaction_op",
                                                "cat"), ("din",), ("dien",),
            ("bst",), ("dssm",), ("esmm",), ("mmoe",), ("dbmtl",),
            ("simple_multitask",))
ZOO_BATCH = 4096
ZOO_ARGS = ["--bf16", "--batch_size", str(ZOO_BATCH), "--steps", "12",
            "--eval_steps", "2", "--log_steps", "12"]
ZOO_STEPS = (2, 5)
ZOO_CPU_ROWS = 256
# Card vs CPU forward of one model on the same embeddings and weights:
# bf16 GEMMs (and attention's bf16 softmax, the GRUs' bf16 steps) round
# differently on the two devices. About 10x the largest reading on an
# H100 (max abs diff 3.816e-3, dbmtl; 1.835e-4 to 3.547e-3 the others).
ZOO_CPU_ATOL = 4e-2
ZOO_RESUME = (6, 9)
ZOO_KERNEL_MODELS = ("din", "deepfm")
# Phase 23 (q): steps of the sharded runs; the sharded step against the
# unsharded one on the same global batches (loss, rows key by key, eval
# logits); (b)'s placement threshold, which replicates the 65-wide table
# (a full footprint of 417 MB: values and two float32 slot arrays, 16
# bytes a row beside) and shards the 129-wide one (6.6 GB). Readings on
# an H100: (a) bit-equal (losses, rows, logits); (b) losses within
# 7.4e-7 relative, rows within 2.9e-7, eval logits within 4.7e-4 (the
# towers' bf16 GEMMs at two batch sizes, gradients summed in halves).
# The bounds: rtol 1e-4 (tests/test_sharded_embedding.py's), rows 35x
# and logits 4x the readings (logits step by 2**-8 near 1 in bf16).
SHARDED_STEPS = 5
SHARDED_LOSS_RTOL = 1e-4
SHARDED_ROW_TOL = dict(rtol=1e-4, atol=1e-5)
SHARDED_LOGIT_ATOL = 2e-3
GLOO_REPLICATE_THRESHOLD = 1 << 30
# Phase 22 (p): each of ZOO_RUNS at full width and B = ZOO_BATCH trained
# on a pool of ZOO_EPOCH_POOL batches for ZOO_EPOCH_EPOCHS epochs, eager
# against captured.
ZOO_EPOCH_POOL, ZOO_EPOCH_EPOCHS = 4, 2
# Then each measuring tool once, at its smallest useful size: the AUC
# campaign's DIN for 3 epochs of 4 batches (bf16 and the fp32 twin,
# merged by zoo_delta_torch), the model benchmark's DeepFM with short
# warm-up and measured runs, the serving benchmark at two batch sizes,
# the step breakdown at a capacity ceiling of 2**17, and every job of
# the kernel benchmark at its own shapes.
TOOL_AUC_STEPS, TOOL_AUC_POOL = 12, 4
ZOO_AUC_ROW_KEYS = {"metric", "mode", "backend", "steps", "batch", "seed",
                    "train_s_incl_compile", "loss_epoch_means", "loss_drops",
                    "auc"}
TOOL_BENCH_STEPS = (8, 14)
TOOL_SERVING_BATCHES, TOOL_SERVING_REQUESTS = (1, 512), 10
TOOL_BREAKDOWN_ARGS = ["--cap", "17"]
# Phase 24 (r): the table variants on the zoo's WDL at full width, B =
# ZOO_BATCH, bf16 towers: the adaptive tool run (12 steps, threshold 3,
# 2**14 buckets), then in-process steps (VARIANT_STEPS: warm-up, timed)
# of the adaptive, dyn-dim (its deep columns in 4 blocks unlocking at
# VARIANT_THRESHOLDS) and dyn-dim-with-hot-sibling models; each kernel
# held against its plain version on a step's operands, the
# VARIANT_LIMIT calls of largest operands of each (the adaptive WDL has
# 52 tables); the adaptive model's captured epoch over VARIANT_POOL
# batches; one TensibleEV growth; one NCCL rank of the adaptive and
# dyn-dim-hot models on a mesh for VARIANT_MESH_STEPS steps against the
# unsharded models (phase 23's tolerances).
VARIANT_TOOL_ARGS = ["wdl", "--adaptive_emb", "--bf16", "--batch_size",
                     str(ZOO_BATCH), "--steps", "12", "--eval_steps", "2"]
VARIANT_STEPS = (2, 4)
VARIANT_THRESHOLDS = (2, 4, 6)
VARIANT_HOT_SHARE = 16  # hot sibling capacity = capacity / 16
VARIANT_LIMIT = 2
VARIANT_POOL = 4
VARIANT_MESH_STEPS = 3
TENSIBLE_CAPACITY, TENSIBLE_DIM, TENSIBLE_BATCH = 1 << 16, 64, 16384
# Phase 25 (s): the headline WDL with multi-tier tables, fed unseen
# batches of the e2e row's vocabulary (SyntheticCriteo(vocab=TIER_VOCAB,
# seed=TIER_SEED); the 65-wide table sees ~77,000 distinct ids a batch
# and passes its 524,288 slots in the 11th): (a) TIER_STEPS batches, then
# its first TIER_REFEED again, watermarks 0.85 / 0.70, a demotion check
# every 4 steps; (b) the 65-wide table on three tiers, host_capacity
# TIER_HOST_CAPACITY, TIER_DISK_STEPS batches and TIER_REFEED again;
# (d) SparseAdam and (e) one NCCL rank: TIER_SHORT[0] batches, then the
# first TIER_SHORT[1] again, a check every 2 steps, at watermarks that
# demote within them: (d) TIER_SHORT_MARKS (the 65-wide table passes 0.4
# of its slots at step 4), (e) TIER_MESH_MARKS on the headline's own
# stream (whose 65-wide table holds 7-12 % of its slots in 2-6 steps, and
# whose steps drop no id: the unsharded step's unique budget would drop
# ids the sharded one keeps). The round-trip gate: at least
# TIER_GATE_KEYS keys of a table's first demotion checked bit for bit on
# their first promotion.
TIER_VOCAB, TIER_SEED = 200_000, 7
TIER_STEPS, TIER_REFEED = 24, 4
TIER_DISK_STEPS = 12
TIER_HOST_CAPACITY = 65_536
TIER_SHORT = (6, 2)
TIER_SHORT_MARKS = (0.4, 0.3)
TIER_MESH_MARKS = (0.05, 0.03)
TIER_GATE_KEYS = 1024
# Phase 26 (t): the rest of serving on phase 4's headline checkpoint:
# warmup on 2 requests and SERVE_REQUESTS KServe requests of SERVE_ROWS
# rows; the C ABI's process and batch_process of ABI_ROWS rows and its
# latency over ABI_REPS calls at 1 and ABI_ROWS rows; remote scoring of
# SERVE_ROWS rows against ServingModel (a host float32 combine against
# the device's: both sum one id a bag exactly, so the logits are
# expected bit-equal; the bound is phase 5's card-vs-CPU bound); the
# int8 tables' accuracy_delta over LP_EVAL_BATCHES batches of BATCH.
SERVE_CONFIG = {"reference_shapes": True}  # wdl_entry's: the headline
SERVE_ROWS, SERVE_REQUESTS = 512, 4
ABI_ROWS, ABI_REPS = 64, 20
REMOTE_LOGIT_ATOL = CPU_LOGIT_ATOL
LP_EVAL_BATCHES = 4
# Phase 26 (e)'s checks of the int8 tables: every dequantized value lies
# within half a step (its row's scale) of the f32 one, with room for
# float32 rounding; and the int8 logits within LP_LOGIT_ATOL of the f32
# ones on the first eval batch (about five times the 0.00941 read on an
# NVIDIA H100 80GB HBM3 at 700 W; a wrong scale moves them further).
LP_HALF_STEP = 0.5 + 1e-3
LP_LOGIT_ATOL = 0.05
# Phase 27 (u): (a) the headline trained on KAFKA_BATCHES batches of TSV
# lines of its own stream (SyntheticCriteo(vocab=CRITEO_HASH_BUCKETS,
# seed=0): each column's ids within its bucket count, so the tables'
# unique budgets drop no id; the e2e row's 200,000-id vocabulary
# overflows them, ~10,000 ids a step on an NVIDIA H100 80GB HBM3 at
# 700 W) through the port's MiniKafkaBroker, one partition of
# KAFKA_TOPIC, polled KAFKA_POLL_S at most a fetch; then a run stopped
# after KAFKA_STOP batches and resumed from state(), half way. (b) One
# NCCL rank of the sharded headline by make_epoch_step(mesh=) on a pool
# of MESH_EPOCH_POOL batches for MESH_EPOCH_EPOCHS epochs: 7 replays,
# each wrapping the pool once, in a few seconds.
KAFKA_BATCHES, KAFKA_STOP = 8, 4
KAFKA_TOPIC = "criteo"
# Then KAFKA_E2E_BATCHES batches of the e2e row's stream on KAFKA_E2E_TOPIC
# against the same lines from a file, its overflow held equal on both
# sides: three steps show the dropped ids agree, in a few seconds.
KAFKA_E2E_BATCHES = 3
KAFKA_E2E_TOPIC = "criteo_e2e"
KAFKA_POLL_S = 0.05
MESH_EPOCH_POOL, MESH_EPOCH_EPOCHS = 4, 2


def log(msg: str):
    print(msg, flush=True)


def median_ms(fn) -> float:
    """Device time of one call of ``fn``: GRAPH_CALLS calls captured in a
    CUDA graph, the median over REPS replays divided by GRAPH_CALLS.
    Each timed replay is queued behind an untimed one, so the card never
    waits on the host: a wrapper's launch overhead (tens of us of
    Python) is not counted, as it is not on the card in a step whose
    launches run ahead. Back-to-back calls find their operands partly
    in L2 where they fit (50 MB)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        graph.replay()
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / GRAPH_CALLS)
    del graph
    return float(np.median(times))


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    CARD["smi"] = smi.strip().splitlines()[0]
    log(CARD["smi"])
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    CARD["clock_hz"] = float(clock.strip().splitlines()[0]) * 1e6
    CARD["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.cuda.get_device_name(0)


_KIND_OF = {0: "zeros", 1: "constant", 2: "uniform", 3: "normal",
            4: "truncated_normal"}


def shortest_path_instructions(sass: str) -> int:
    """Instructions issued on the shortest path from the entry of a
    function's SASS (``cuobjdump -sass`` lines of one function) to an
    unpredicated EXIT: a conditional branch may go either way, a CALL
    counts as one instruction, NOPs count nothing. Any run of the
    function issues at least that many."""
    import heapq
    ins = []
    for line in sass.splitlines():
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]+);", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2).split()))
    at = {addr: i for i, (addr, _) in enumerate(ins)}
    dist = [None] * len(ins)
    heap = [(0, 0)]
    while heap:
        d, i = heapq.heappop(heap)
        if i >= len(ins) or dist[i] is not None:
            continue
        dist[i] = d
        toks = ins[i][1]
        pred = toks[0].startswith("@")
        op = toks[1] if pred else toks[0]
        d += op != "NOP"
        if op == "EXIT" and not pred:
            return d
        if op.startswith("RET") and not pred:
            continue
        nxt = []
        if op.startswith("BRA"):
            nxt.append(at[int(toks[-1], 16)])
            if pred:
                nxt.append(i + 1)
        else:
            nxt.append(i + 1)
        for j in nxt:
            heapq.heappush(heap, (d, j))
    raise AssertionError("no path to an EXIT in the SASS")


def draw_instructions() -> dict:
    """SASS instructions an element of P2's draw takes at least, by
    initializer: ``tools/init_rows_one_element.cu`` (one kernel an
    initializer, a single element each) built with ``init_rows``' flags
    into a cubin, each kernel's shortest path from its entry to its
    EXIT (:func:`shortest_path_instructions`): the slow paths of
    ``cosf`` (a large argument) and ``sqrtf`` (special values) sit
    behind branches no element of the draw takes."""
    from deeprec_tpu_torch.ops.kernels import build
    out_dir = os.path.join(ROOT, "build", "sass")
    os.makedirs(out_dir, exist_ok=True)
    cubin = os.path.join(out_dir, "init_rows_one_element.cubin")
    flags = [f for f in build.NVCC_FLAGS + build.KERNEL_FLAGS["init_rows"]
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([build._nvcc(), *flags, "-cubin", "-o", cubin,
                    os.path.join(ROOT, "tools", "init_rows_one_element.cu")],
                   check=True, capture_output=True, text=True, timeout=600)
    sass = subprocess.run(
        [os.path.join(os.path.dirname(build._nvcc()), "cuobjdump"), "-sass",
         cubin], check=True, capture_output=True, text=True,
        timeout=120).stdout
    counts = {}
    for part in re.split(r"Function : ", sass)[1:]:
        head = re.match(r"\S*draw_one\S*ILi(\d)E", part)
        if head:
            counts[_KIND_OF[int(head.group(1))]] = \
                shortest_path_instructions(part)
    if set(counts) != set(_KIND_OF.values()):
        raise AssertionError(f"draw_instructions: SASS counts {counts}")
    return counts


def ops_bound_ms(instructions: float) -> float:
    """Least time to issue ``instructions`` lane instructions on every
    SM of the card at its maximum SM clock."""
    rate = CARD["sms"] * LANES_PER_SM_CYCLE * CARD["clock_hz"]
    return instructions / rate * 1e3


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from deeprec_tpu_torch.ops.kernels import build
    names = build.KERNELS
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 1) as pool:
        sass = pool.submit(draw_instructions)
        for f in [pool.submit(build.load_library, n) for n in names]:
            f.result()
        DRAW_INSTRUCTIONS.update(sass.result())
    log(f"phase 2 build: {', '.join(names)} ready in "
        f"{time.perf_counter() - t0:.3f} s (nvcc " + ", ".join(
            f"{n} {build.build_seconds[n]:.3f} s" for n in names) + "); "
        f"P2's draw takes {DRAW_INSTRUCTIONS} SASS instructions an "
        f"element; {CARD['sms']} SMs at most {CARD['clock_hz'] / 1e6:.0f} "
        f"MHz")


def bound_ms(nbytes: float) -> float:
    """Least time to move ``nbytes`` at the card's peak memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase_kernel() -> float:
    """Kernel vs plain version at the serving shapes (timed) and at edge
    cases; returns the largest error seen (0.0: a gather is a copy)."""
    from deeprec_tpu_torch.ops.kernels import gather
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0

    def check(values, slots, *sel):
        nonlocal max_err
        got = gather.gather_rows(values, slots, *sel)
        want = gather.gather_rows_reference(values, slots, *sel)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"gather_rows: shape/dtype {got.shape} "
                                 f"{got.dtype} vs {want.shape} {want.dtype}")
        if got.numel():
            err = float((got.float() - want.float()).abs().max())
            max_err = max(max_err, err)
            if not torch.equal(got, want):
                raise AssertionError(f"gather_rows differs from its plain "
                                     f"version: max abs err {err}")

    def slots_for(C1, n):
        s = torch.randint(0, C1, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        k = max(1, n // 100)
        s[:k] = C1 - 1                       # the sentinel row C
        s[k:2 * k] = C1 + 17                 # above C
        s[2 * k:3 * k] = -5                  # negative
        s[3 * k:3 * k + 1] = 2**31 - 1
        return s

    for C1, D, n in ((4194305, 129, BATCH * 8), (524289, 65, BATCH * 18)):
        values = torch.randn(C1, D, generator=gen, device=dev)
        slots = slots_for(C1, n)
        admitted = torch.rand(n, generator=gen, device=dev) < 0.9
        bank = torch.randn(1, D, generator=gen, device=dev)
        check(values, slots)
        check(values, slots, admitted, bank)
        ms = median_ms(lambda: gather.gather_rows(values, slots))
        plain = median_ms(lambda: gather.gather_rows_reference(values, slots))
        ms_sel = median_ms(
            lambda: gather.gather_rows(values, slots, admitted, bank))
        plain_sel = median_ms(lambda: gather.gather_rows_reference(
            values, slots, admitted, bank))
        clamped = torch.clamp(slots.long(), 0, C1 - 1)
        lib = median_ms(lambda: torch.nn.functional.embedding(clamped,
                                                              values))
        gbs = 2 * n * D * 4 / (ms_sel * 1e-3) / 1e9
        # Each output row read once and written once, plus the slot
        # (4 B) and admitted flag (1 B) of every row.
        bound = bound_ms(2 * n * D * 4 + 5 * n)
        log(f"phase 3 kernel: table [{C1}, {D}] f32, n={n}: gather "
            f"{ms:.4f} ms (plain {plain:.4f} ms, F.embedding {lib:.4f} "
            f"ms); with default select {ms_sel:.4f} ms (plain "
            f"{plain_sel:.4f} ms), {gbs:.1f} GB/s moved by the kernel, "
            f"bound {bound:.4f} ms")
        del values, slots, admitted, bank, clamped
    torch.cuda.empty_cache()
    # Edge cases: widths below, at and one above multiples of the warp,
    # bf16 at odd D, n below a warp and ragged against the 16-row tiles,
    # empty n, a multi-row default bank; slots_for makes every case read
    # the table's last row (C), which ends the allocation.
    cases = 0
    for D in EDGE_WIDTHS:
        for dtype in ((torch.float32, torch.bfloat16) if D % 2
                      else (torch.float32,)):
            C1 = 100003
            values = torch.randn(C1, D, generator=gen, device=dev).to(dtype)
            bank = torch.randn(3, D, generator=gen, device=dev).to(dtype)
            for n in (0, 5, 31, 4099, 77777):
                slots = slots_for(C1, n) if n else torch.zeros(
                    0, dtype=torch.int32, device=dev)
                admitted = torch.rand(n, generator=gen, device=dev) < 0.5
                sel = torch.randint(0, 3, (n,), generator=gen, device=dev,
                                    dtype=torch.int32)
                check(values, slots)
                check(values, slots, admitted, bank)
                check(values, slots, admitted, bank, sel)
                cases += 3
            del values, bank
    log(f"phase 3 kernel: equal to the plain version on every case "
        f"({cases} edge cases; max abs err {max_err})")
    return max_err


@contextlib.contextmanager
def captured_gathers():
    """Record the operands of every ``gather_rows`` call the lookups make
    (``variable`` calls it through the module), still launching K1."""
    from deeprec_tpu_torch.ops.kernels import gather
    calls = []
    kernel_fn = gather.gather_rows

    def recording(*args):
        calls.append(args)
        return kernel_fn(*args)

    gather.gather_rows = recording
    try:
        yield calls
    finally:
        gather.gather_rows = kernel_fn


def _gather_bytes(values, slots, admitted, bank, sel) -> int:
    """Bytes a fetch with these operands must move: each output row
    written once, each distinct source row (table or bank) read once,
    and the slot (4 B), admitted flag (1 B) and select index (4 B) of
    every row. On the training path most rows read the one bank row."""
    n, D = slots.numel(), values.shape[1]
    C = values.shape[0] - 1
    src = torch.clamp(slots.long(), 0, C)
    head = 4
    if admitted is not None:
        b = (torch.clamp(sel.long(), 0, bank.shape[0] - 1) if sel is not None
             else torch.zeros_like(src))
        src = torch.where(admitted, src, C + 1 + b)
        head += 1 + (4 if sel is not None else 0)
    distinct = int(torch.unique(src).numel())
    return (n + distinct) * D * values.element_size() + head * n


def _pct(rec) -> str:
    return f"{100 * rec['bound_ms'] / rec['ms']:.1f} % of bound"


def compare_gather(label: str, values, slots, admitted=None, bank=None,
                   sel=None) -> dict:
    """K1 on a lookup's own operands: equal to its plain version; median
    times of both and of ``F.embedding`` on the clamped slots; the bound
    from what these operands need."""
    from deeprec_tpu_torch.ops.kernels import gather
    args = (values, slots, admitted, bank, sel)
    got = gather.gather_rows(*args)
    want = gather.gather_rows_reference(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"gather_rows {label}: differs from its plain "
                             f"version")
    C1, D = values.shape
    clamped = torch.clamp(slots.long(), 0, C1 - 1)
    rec = {"max_abs_err": 0.0,
           "ms": median_ms(lambda: gather.gather_rows(*args)),
           "plain_ms": median_ms(lambda: gather.gather_rows_reference(*args)),
           "library_ms": median_ms(
               lambda: torch.nn.functional.embedding(clamped, values)),
           "bound_ms": bound_ms(_gather_bytes(*args))}
    log(f"phase {label}: gather_rows [{C1}, {D}] "
        f"{str(values.dtype).split('.')[-1]}, n={slots.numel()}, "
        f"{int(admitted.sum()) if admitted is not None else slots.numel()} "
        f"admitted: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} "
        f"ms, F.embedding {rec['library_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({_pct(rec)}); equal to the plain "
        f"version")
    return rec


def event_ms(fn, reps: int = 5) -> float:
    """Time of one call of ``fn`` between CUDA events, the median over
    ``reps`` calls after an untimed one, for functions that read the
    card from the host (the plain probe), which a CUDA graph cannot
    capture; the host's waits count."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


@contextlib.contextmanager
def captured_probes(clone_finds: bool = False):
    """Record the operands of every probe the lookups make (``variable``
    calls them through the module), still running P1: ("insert", the
    key rows as they were before the call, qhi, qlo, insert mask,
    max_probes) or ("find", key rows, qhi, qlo, None, max_probes); a
    find's key rows are a copy with ``clone_finds`` (for callers that
    change the table after the find, as ``delete_keys`` does)."""
    from deeprec_tpu_torch.embedding import hash_table as ht
    calls = []
    insert_fn, find_fn = ht.find_or_insert, ht.find

    def insert(table, qhi, qlo, insert_mask, max_probes=64, max_rounds=128):
        calls.append(("insert", table.key_rows.clone(), qhi.clone(),
                      qlo.clone(), insert_mask.to(torch.bool).clone(),
                      max_probes))
        return insert_fn(table, qhi, qlo, insert_mask, max_probes,
                         max_rounds)

    def find(table, qhi, qlo, max_probes=64):
        rows = table.key_rows.clone() if clone_finds else table.key_rows
        calls.append(("find", rows, qhi.clone(), qlo.clone(), None,
                      max_probes))
        return find_fn(table, qhi, qlo, max_probes)

    ht.find_or_insert, ht.find = insert, find
    try:
        yield calls
    finally:
        ht.find_or_insert, ht.find = insert_fn, find_fn


def _plain_rounds(fn):
    """(result of ``fn()``, straggler rounds the plain ``find`` ran)."""
    from deeprec_tpu_torch.embedding import hash_table as ht
    rounds = [0]
    compact = ht._compact

    def counting(*args):
        rounds[0] += 1
        return compact(*args)

    ht._compact = counting
    try:
        return fn(), rounds[0]
    finally:
        ht._compact = compact


def compare_probe(label: str, kind: str, rows0, qhi, qlo, mask,
                  max_probes: int, time_it: bool = True) -> dict:
    """P1 (``kind`` "insert" or "find") on these operands against its
    plain version, each on its own copy of the key rows ``rows0``:
    slots, ``is_new`` and key rows must be equal; an insert's kernel
    must have run the plain version's rounds, or stopped at its first
    round whose every id was dead. With ``time_it``:
    device times (an insert restores the key rows before each call, and
    that copy's time is taken off; the fast round apart, ``max_rounds``
    1), the plain version's event-fenced time (its host reads included)
    and the bound: the key rows the ids' windows touch (each row once:
    the bucket rows of all real ids, the wide windows of the ids the
    fast round left pending) plus the ids, mask, slots, flags and
    written keys, over the card's memory rate."""
    from deeprec_tpu_torch.embedding import hash_table as ht
    from deeprec_tpu_torch.ops.kernels import hash_probe
    from deeprec_tpu_torch.utils import keys as keylib
    from deeprec_tpu_torch.utils import trace
    n = qhi.numel()
    n_rows, row = rows0.shape
    W = row // 2
    capacity = n_rows * W
    R = ht._wide_rows(rows0, max_probes)
    real = qhi != keylib.EMPTY_HI
    starts = ht._start_slots(qhi, qlo, capacity)
    found, _, _, _, saw_empty = ht._scan_fast(rows0, qhi, qlo, starts)
    if kind == "find":
        got = ht.find(ht.HashTable(rows0), qhi, qlo, max_probes)
        want, rounds = _plain_rounds(lambda: ht.find_reference(
            ht.HashTable(rows0), qhi, qlo, max_probes))
        if not torch.equal(got, want):
            raise AssertionError(f"P1 find {label}: slots differ from the "
                                 f"plain version")
        pending = real & ~found & ~saw_empty & (n_rows > 1)
        per_id, new, k_rounds, stats = 12, 0, None, {}
        rounds = f"plain {rounds} wide rounds"
    else:
        kt, pt = ht.HashTable(rows0.clone()), ht.HashTable(rows0.clone())
        (_, ks, kn), counters = trace.counted(
            lambda: ht.find_or_insert(kt, qhi, qlo, mask, max_probes))
        k_rounds = int(counters["probe_rounds"])
        stats = {}
        _, ps, pn = ht.find_or_insert_reference(pt, qhi, qlo, mask,
                                                max_probes, stats=stats)
        if not (torch.equal(ks, ps) and torch.equal(kn, pn)
                and torch.equal(kt.key_rows, pt.key_rows)):
            raise AssertionError(f"P1 insert {label}: slots, is_new or key "
                                 f"rows differ from the plain version")
        if k_rounds != (stats["first_dead_round"] or stats["rounds"]):
            raise AssertionError(f"P1 insert {label}: the kernel ran "
                                 f"{k_rounds} rounds, the plain version "
                                 f"{stats}")
        rounds = (f"kernel {k_rounds} rounds, plain {stats['rounds']} "
                  f"(first all-dead round {stats['first_dead_round']})")
        _, s1, _ = ht.find_or_insert_reference(
            ht.HashTable(rows0.clone()), qhi, qlo, mask, max_probes,
            max_rounds=1)
        pending = real & (s1 == capacity) & (mask | ~saw_empty)
        per_id, new = 14, int(kn.sum())
        got = ks
    r0 = (starts // W).long()
    touched = [r0[real]]
    if bool(pending.any()):
        ahead = torch.arange(R, device=r0.device)
        touched.append(((r0[pending][:, None] + ahead[None, :]) % n_rows)
                       .reshape(-1))
    n_touched = int(torch.unique(torch.cat(touched)).numel())
    nbytes = n_touched * row * 4 + per_id * n + 8 * new
    rec = {"max_abs_err": 0.0, "library_ms": None, "n": n,
           "pending_after_fast": int(pending.sum()), "rounds": k_rounds,
           "plain_rounds": stats.get("rounds"),
           "first_dead_round": stats.get("first_dead_round"),
           "rows_touched": n_touched, "bound_ms": bound_ms(nbytes),
           "missing": int((real & (got >= capacity)).sum()), "new": new}
    if not time_it:
        return rec
    if kind == "find":
        rec["ms"] = median_ms(lambda: hash_probe.find(rows0, qhi, qlo, R))
        rec["plain_ms"] = event_ms(lambda: ht.find_reference(
            ht.HashTable(rows0), qhi, qlo, max_probes))
        split = ""
    else:
        M = ht._straggler_budget(n)
        work = rows0.clone()
        claim = hash_probe.claim_buffer(capacity, rows0.device)

        def run(rounds):
            work.copy_(rows0)
            hash_probe.find_or_insert(work, qhi, qlo, mask, claim, R, M,
                                      rounds)

        copy = median_ms(lambda: work.copy_(rows0))
        rec["ms"] = median_ms(lambda: run(128)) - copy
        rec["fast_ms"] = median_ms(lambda: run(1)) - copy
        rec["straggler_ms"] = rec["ms"] - rec["fast_ms"]
        rec["plain_ms"] = event_ms(lambda: (
            work.copy_(rows0), ht.find_or_insert_reference(
                ht.HashTable(work), qhi, qlo, mask, max_probes))) - copy
        split = (f" (fast round {rec['fast_ms']:.4f}, straggler kernel "
                 f"{rec['straggler_ms']:.4f})")
    log(f"phase {label}: P1 {kind} [{capacity} slots], n={n}, "
        f"{rec['pending_after_fast']} pending after the fast round, "
        f"{rounds}, {new} inserted, {rec['missing']} "
        f"real ids without a slot, {n_touched} key rows touched: kernel "
        f"{rec['ms']:.4f} ms{split}, plain {rec['plain_ms']:.4f} ms (host "
        f"reads included), "
        f"bound {rec['bound_ms']:.4f} ms ({_pct(rec)}); equal to the plain "
        f"version")
    return rec


def compare_probes(label: str, calls, time_it: bool = True) -> list:
    """:func:`compare_probe` on every recorded probe call."""
    return [compare_probe(f"{label} {kind}", kind, rows0, qhi, qlo, mask,
                          max_probes, time_it)
            for kind, rows0, qhi, qlo, mask, max_probes in calls]


@contextlib.contextmanager
def captured_inits():
    """Record the operands of every fresh-row draw the training lookups
    make (``variable`` calls ``init_rows.init_fresh`` through the
    module), still launching P2: (the values as they were before the
    call, fresh, slots, qhi, qlo, initializer, scale, salt)."""
    from deeprec_tpu_torch.ops.kernels import init_rows
    calls = []
    kernel_fn = init_rows.init_fresh

    def recording(values, *args):
        calls.append((values.clone(),) + tuple(
            a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return kernel_fn(values, *args)

    init_rows.init_fresh = recording
    try:
        yield calls
    finally:
        init_rows.init_fresh = kernel_fn


def compare_init(label: str, values0, fresh, slots, qhi, qlo, initializer,
                 scale, salt) -> dict:
    """P2 on a lookup's own operands against its plain version, each on
    its own copy of ``values0``: the largest difference over the whole
    table, within ``INIT_ATOL`` (times the scale) for the normal kinds,
    zero for the others. Device times of both (repeated calls write the
    same rows) and two bounds: bytes (the fresh flags, the slot and id
    of every fresh entry and each distinct fresh row written once) and
    operations (each element of a distinct fresh row drawn once, at
    ``DRAW_INSTRUCTIONS`` instructions an element, over the SMs' issue
    rate); the record's bound is the larger."""
    from deeprec_tpu_torch.ops.kernels import init_rows
    args = (fresh, slots, qhi, qlo, initializer, scale, salt)
    got, want = values0.clone(), values0.clone()
    init_rows.init_fresh(got, *args)
    init_rows.init_fresh_reference(want, *args)
    err = float((got.float() - want.float()).abs().max())
    atol = (INIT_ATOL * scale
            if initializer in ("normal", "truncated_normal") else 0.0)
    if not err <= atol:
        raise AssertionError(f"init_fresh {label}: differs from its plain "
                             f"version by {err} (bound {atol})")
    C1, D = values0.shape
    on = fresh & (slots < C1 - 1)
    n, n_fresh = fresh.numel(), int(on.sum())
    rows = int(torch.unique(slots[on]).numel())
    nbytes = n + 12 * n_fresh + rows * D * values0.element_size()
    byte_ms = bound_ms(nbytes)
    op_ms = ops_bound_ms(DRAW_INSTRUCTIONS[initializer] * rows * D)
    rec = {"max_abs_err": err, "library_ms": None, "n": n,
           "fresh": n_fresh, "rows": rows,
           "ms": median_ms(lambda: init_rows.init_fresh(got, *args)),
           "plain_ms": median_ms(
               lambda: init_rows.init_fresh_reference(want, *args)),
           "bytes_bound_ms": byte_ms, "ops_bound_ms": op_ms,
           "bound_ms": max(byte_ms, op_ms),
           "bound_by": "operations" if op_ms > byte_ms else "bytes"}
    del got, want
    log(f"phase {label}: init_fresh [{C1}, {D}] {initializer}, n={n}, "
        f"{n_fresh} fresh entries, {rows} fresh rows: kernel "
        f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms; byte bound "
        f"{byte_ms:.4f} ms ({100 * byte_ms / rec['ms']:.1f} %), arithmetic "
        f"bound {op_ms:.4f} ms ({100 * op_ms / rec['ms']:.1f} %; "
        f"{DRAW_INSTRUCTIONS[initializer]} instructions an element); max "
        f"abs difference from the plain version {err:.3g}")
    return rec


def unseen_batch(tr, k: int):
    """The trainer's next batch from its stream with every categorical id
    moved by ``k * 2**56``, past any id the stream draws: every key is
    new to the tables (and to the batches of every other ``k``)."""
    raw = tr.data.next_batch_np(wide=tr.wide)
    raw = {key: v + (k << 56) if key.startswith("C") else v
           for key, v in raw.items()}
    return tr.group.pack_batch_np(raw, tr.device)


def capture_without_sync(label: str, what: str, fn) -> None:
    """``fn`` captured in a CUDA graph and not replayed: capture fails on
    any host read or synchronizing call, which makes it a second witness
    beside ``set_sync_debug_mode``, one that misses none. The operands
    must exist before (nothing ``fn`` allocates outlives the graph)."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    del graph
    torch.cuda.synchronize()
    log(f"phase {label}: {what} captured in a CUDA graph: no host sync")


def lookups_without_sync(label: str, group, states, batch,
                         step=None) -> None:
    """The lookups of ``batch`` (training lookups at ``step``, else the
    serving lookups) under ``set_sync_debug_mode("error")``: any host
    read raises."""
    from deeprec_tpu_torch.embedding import variable as ev
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        if step is not None:
            group.lookup_train(states, batch, step)
        else:
            for tname, tcols in group._columns_by_table().items():
                hi, lo, _ = group._packed_view(batch, tname, tcols)
                ev.lookup(group.tables[tname], states[tname],
                          hi.reshape(-1), lo.reshape(-1))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"phase {label}: the lookups ran under set_sync_debug_mode('error'):"
        f" no host sync")


def phase_state(ckpt_dir: str):
    """Fill the reference-shape tables and save a full checkpoint."""
    from deeprec_tpu_torch.data.criteo import (CRITEO_HASH_BUCKETS,
                                               SyntheticCriteo)
    from deeprec_tpu_torch.embedding import variable as ev
    from deeprec_tpu_torch.serving import wdl_entry
    from deeprec_tpu_torch.train.checkpoint import CheckpointManager
    from deeprec_tpu_torch.utils import keys as keylib
    from deeprec_tpu_torch.utils import stateless_random as srand

    t0 = time.perf_counter()
    parts = wdl_entry.build({"device": "cuda", "reference_shapes": True})
    group, ts = parts["group"], parts["ts_template"]
    data = SyntheticCriteo(batch_size=BATCH, vocab=CRITEO_HASH_BUCKETS,
                           seed=0)
    ids = {t: [] for t in group.tables}
    for _ in range(INSERT_BATCHES):
        raw = data.next_batch_np(wide=False)
        for c in group.embedding:
            hi, lo = group.transform_ids_np(c, raw[c.name])
            ids[group.physical_table_of(c)].append(
                keylib.join_ids(hi, lo).ravel())
    dev_bytes = 0
    for tname, cfg in group.tables.items():
        keys = np.unique(np.concatenate(ids[tname]))
        hi, lo = keylib.split_ids(keys)
        rows = srand.init_rows(
            cfg.initializer, torch.from_numpy(hi).cuda(),
            torch.from_numpy(lo).cuda(), cfg.dim, cfg.init_scale,
            salt=group.salts[tname]).to(cfg.dtype)
        st = ts.ev[tname]
        ev.import_arrays(cfg, st, {
            "keys": keys, "values": rows.cpu().numpy(),
            "freqs": np.ones(keys.size, np.int32),
            "versions": np.zeros(keys.size, np.int32)}, chunk=1 << 16)
        live = int(ev.num_live(st))
        if live != keys.size:
            raise AssertionError(f"{tname}: {live} live keys after "
                                 f"inserting {keys.size}")
        nbytes = sum(t.numel() * t.element_size() for t in (
            st.table.key_rows, st.values, st.freqs, st.versions,
            st.default_bank, st.bloom))
        dev_bytes += nbytes
        log(f"phase 4 state: table {tname.split(':')[0]}[{cfg.dim} x "
            f"{cfg.capacity + 1}]: {live} live keys, {nbytes} device bytes")
    ts = ts.replace(step=1)
    CheckpointManager(ckpt_dir, group).save(ts)
    log(f"phase 4 state: {dev_bytes} table bytes on the card, "
        f"{torch.cuda.memory_allocated()} allocated; checkpoint saved in "
        f"{time.perf_counter() - t0:.3f} s")
    return parts, data.next_batch_np(wide=False)


def phase_serving(parts, raw, ckpt_dir: str):
    """Restore and score through the kernel; returns (logits, launches)."""
    from deeprec_tpu_torch.ops.kernels import gather, hash_probe
    from deeprec_tpu_torch.serving import wdl_entry
    from deeprec_tpu_torch.serving.processor import ServingModel

    group = parts["group"]
    batch = group.pack_batch_np(raw, "cpu")
    gather.launches = 0                       # the main path starts here
    hash_probe.launches["find"] = 0
    t0 = time.perf_counter()
    serving = ServingModel(group, parts["apply_fn"], parts["ts_template"],
                           ckpt_dir)
    version = serving.full_update()
    restore_s = time.perf_counter() - t0
    lat = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = serving.predict(batch)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t1)
    launches = {"gather_rows": gather.launches,
                "hash_probe_find": hash_probe.launches["find"]}
    if min(launches.values()) < 1:            # the main path ends here
        raise AssertionError(f"the serving path did not launch every "
                             f"kernel: {launches}")
    if out.shape != (BATCH,) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"bad logits: shape {tuple(out.shape)}")
    log(f"phase 5 serving: restored version {version} in {restore_s:.3f} s; "
        f"batch {BATCH} latency first {lat[0] * 1e3:.3f} ms, median of "
        f"the rest {np.median(lat[1:]) * 1e3:.3f} ms; launches "
        f"{launches}")

    # The same state scored with the plain gather: ``variable.lookup``
    # calls ``gather.gather_rows`` through the module, so rebinding it
    # swaps the fetch and nothing else. A gather is a copy and the rest
    # of the path is deterministic, so the logits must be identical.
    kernel_fn = gather.gather_rows
    gather.gather_rows = gather.gather_rows_reference
    try:
        plain = serving.predict(batch)
    finally:
        gather.gather_rows = kernel_fn
    if not torch.equal(out, plain):
        raise AssertionError(f"kernel path vs plain gather: max abs logit "
                             f"diff {float((out - plain).abs().max())}")
    log("phase 5 serving: kernel path vs plain gather, identical logits")
    with captured_gathers() as calls, captured_probes() as probes:
        serving.predict(batch)
    for args in calls:
        compare_gather("5 serving fetch", *args)
    finds = compare_probes("5 serving probe", probes)
    del calls, probes
    lookups_without_sync("5 serving", group, serving._ts.ev,
                         group.pack_batch_np(raw, "cuda"))

    t0 = time.perf_counter()
    cpu = wdl_entry.build({"device": "cpu", "reference_shapes": True})
    cpu_serving = ServingModel(cpu["group"], cpu["apply_fn"],
                               cpu["ts_template"], ckpt_dir)
    cpu_serving.full_update()
    small = {k: v[:SMALL] for k, v in raw.items()}
    ref = cpu_serving.predict(cpu["group"].pack_batch_np(small, "cpu"))
    torch.testing.assert_close(out[:SMALL].cpu(), ref, rtol=0,
                               atol=CPU_LOGIT_ATOL)
    log(f"phase 5 serving: CPU restore and scoring of {SMALL} rows agree, "
        f"max abs logit diff {float((out[:SMALL].cpu() - ref).abs().max())}"
        f" ({time.perf_counter() - t0:.3f} s)")
    return out, launches, finds


def phase_worker(raw, logits, ckpt_dir: str):
    config = {"checkpoint_dir": ckpt_dir, "device": "cuda",
              "reference_shapes": True}
    env = dict(os.environ, DEEPREC_MODEL_CONFIG=json.dumps(config))
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    probs = torch.sigmoid(logits.double()).cpu().numpy()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeprec_tpu_torch.serving.worker",
         "deeprec_tpu_torch.serving.wdl_entry"],
        cwd=ROOT, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        text=True)
    try:
        line = []
        reader = threading.Thread(
            target=lambda: line.append(proc.stdout.readline()), daemon=True)
        reader.start()
        reader.join(timeout=600)
        if not line or not line[0].startswith("PORT "):
            raise AssertionError(f"worker did not report its port: {line}")
        url = f"http://127.0.0.1:{int(line[0].split()[1])}"
        log(f"phase 6 worker: up in {time.perf_counter() - t0:.3f} s")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if health != {"status": "ok", "version": 1}:
            raise AssertionError(f"worker health {health}")
        for start, n in ((0, 1), (0, 512), (0, 4096), (512, 512)):
            rows = range(start, start + n)
            inst = [{**{f"I{i}": float(raw[f"I{i}"][r])
                        for i in range(1, 14)},
                     **{f"C{i}": int(raw[f"C{i}"][r, 0])
                        for i in range(1, 27)}} for r in rows]
            req = urllib.request.Request(
                url + "/v1/predict",
                data=json.dumps({"instances": inst}).encode(),
                headers={"Content-Type": "application/json"})
            t1 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                got = np.asarray(json.loads(r.read())["predictions"])
            dt = time.perf_counter() - t1
            if got.shape != (n,) or not ((got > 0) & (got < 1)).all():
                raise AssertionError(f"worker predictions out of (0, 1) "
                                     f"or of shape {got.shape}")
            diff = float(np.abs(got - probs[start:start + n]).max())
            if diff > PROB_ATOL:
                raise AssertionError(f"worker vs in-process: max abs "
                                     f"diff {diff} > {PROB_ATOL}")
            log(f"phase 6 worker: {n} instances in {dt * 1e3:.3f} ms "
                f"(HTTP+JSON included), max abs diff vs in-process {diff}")
        proc.stdin.close()
        rc = proc.wait(timeout=120)
        if rc != 0:
            raise AssertionError(f"worker exited with {rc}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _apply(kind, values, slots, grads, upd, is_new, tables, args, plain,
           base=None):
    """One K2 (``kind`` "adagrad") or K3 ("adam") call, or its plain
    version, on ``values`` and the slot ``tables`` (rows updated from
    ``base`` where given)."""
    from deeprec_tpu_torch.ops.kernels import sparse_apply as sa
    if kind == "adagrad":
        fn = (sa.adagrad_apply_rows_reference if plain
              else sa.adagrad_apply_rows)
        lr, init_acc = args
        return fn(values, tables[0], slots, grads, lr, update=upd,
                  is_new=is_new, init_acc=init_acc, base_rows=base)
    fn = sa.adam_apply_rows_reference if plain else sa.adam_apply_rows
    return fn(values, tables[0], tables[1], slots, grads, *args, update=upd,
              is_new=is_new, base_rows=base)


def _applied(C, slots, upd, is_new):
    """(applied, fresh): the u-rows an apply updates (``upd``, all when
    None, and 0 <= slot < C), and those of them with ``is_new``."""
    applied = (slots >= 0) & (slots < C)
    if upd is not None:
        applied = applied & upd
    fresh = (applied & is_new if is_new is not None
             else torch.zeros_like(applied))
    return applied, fresh


def _apply_bytes(kind, C, D, slots, upd, is_new) -> int:
    """Bytes an apply with these operands must move. Per element of an
    applied row 20 (Adagrad: read w, acc, g; write w, acc) or 28 (Adam:
    w, m, v, g read; w, m, v written); a fresh row's slot rows are not
    read, so 16 or 20 for it. Per u-row its slot (4 B) and each flag
    given (1 B)."""
    applied, fresh = _applied(C, slots, upd, is_new)
    n_fresh = int(fresh.sum())
    n_old = int(applied.sum()) - n_fresh
    old, new = (20, 16) if kind == "adagrad" else (28, 20)
    head = 4 + (upd is not None) + (is_new is not None)
    return D * (old * n_old + new * n_fresh) + head * slots.numel()


def library_apply(kind, values, tables, slots, grads, upd, args,
                  kernel_values):
    """``torch.optim``'s sparse step on an apply's operands, the library
    yardstick of K2 (``torch.optim.Adagrad``, eps 0 and no lr decay:
    ``w -= lr * g / sqrt(acc + g*g)``) or K3 (``torch.optim.SparseAdam``
    with lr = alpha and a step count so large that both bias corrections
    round to 1: ``w -= alpha * m / (sqrt(v) + eps)``, its moments updated
    as ``m + (1 - beta1) * (g - m)``). The updated rows go in as a
    coalesced sparse COO gradient; the slot state is copied in. Neither
    resets a fresh row's slot state, so the update is K2's or K3's where
    fresh rows hold the initial value, as on a step whose new keys take
    slots never used before. Returns (its time between CUDA events, host
    waits included: its sparse ops read the card; the largest difference
    of its rows from ``kernel_values``, the kernel's rows after one
    apply)."""
    C = values.shape[0] - 1
    applied, _ = _applied(C, slots, upd, None)
    idx = slots[applied].long()
    param = torch.nn.Parameter(values.clone())
    param.grad = torch.sparse_coo_tensor(
        idx[None], grads[applied], values.shape).coalesce()
    if kind == "adagrad":
        lr, init_acc = args
        opt = torch.optim.Adagrad([param], lr=lr, eps=0.0,
                                  initial_accumulator_value=init_acc)
        opt.state[param]["sum"].copy_(tables[0])
    else:
        alpha, beta1, beta2, eps = args
        opt = torch.optim.SparseAdam([param], lr=float(alpha),
                                     betas=(beta1, beta2), eps=eps)
        opt.state[param].update(step=10**6, exp_avg=tables[0].clone(),
                                exp_avg_sq=tables[1].clone())
    opt.step()
    diff = (float((param.detach()[idx] - kernel_values[idx]).abs().max())
            if idx.numel() else 0.0)
    ms = event_ms(opt.step)
    del opt, param
    return ms, diff


def compare_apply(kind, values, tables, slots, grads, upd, is_new, args,
                  label: str, time_it: bool, library: bool = False,
                  base=None) -> dict:
    """Kernel vs plain apply on copies of the same inputs: slot arrays
    equal, rows within APPLY_RTOL/APPLY_ATOL, row C untouched. With
    ``time_it``, median times of both over REPS calls (each applies
    again, in place, on its own copy) and the bound; with ``library``,
    the time of :func:`library_apply` too. ``base``: the rows the apply
    updates from (a dyn-dim table's masked rows, an adaptive table's
    seeds); it reads them in place of the table's, as many bytes."""
    C = values.shape[0] - 1
    kv, pv = values.clone(), values.clone()
    kt = [t.clone() for t in tables]
    pt = [t.clone() for t in tables]
    _apply(kind, kv, slots, grads, upd, is_new, kt, args, plain=False,
           base=base)
    _apply(kind, pv, slots, grads, upd, is_new, pt, args, plain=True,
           base=base)
    torch.cuda.synchronize()
    for a, b in zip(kt, pt):
        if not torch.equal(a, b):
            raise AssertionError(f"{kind} {label}: slot arrays differ from "
                                 f"the plain version, max abs err "
                                 f"{float((a - b).abs().max())}")
    err = float((kv - pv).abs().max()) if kv.numel() else 0.0
    torch.testing.assert_close(kv, pv, rtol=APPLY_RTOL, atol=APPLY_ATOL)
    if not torch.equal(kv[C], values[C]):
        raise AssertionError(f"{kind} {label}: the kernel wrote row C")
    rec = {"max_abs_err": err}
    if library:
        rec["library_ms"], rec["library_diff"] = library_apply(
            kind, values, tables, slots, grads, upd, args, kv)
    if time_it:
        D = values.shape[1]
        applied, fresh = _applied(C, slots, upd, is_new)
        nbytes = _apply_bytes(kind, C, D, slots, upd, is_new)
        rec["ms"] = median_ms(lambda: _apply(kind, kv, slots, grads, upd,
                                             is_new, kt, args, plain=False,
                                             base=base))
        rec["plain_ms"] = median_ms(lambda: _apply(
            kind, pv, slots, grads, upd, is_new, pt, args, plain=True,
            base=base))
        rec["bound_ms"] = bound_ms(nbytes)
        rec["updated"] = int(applied.sum())
        rec["fresh"] = int(fresh.sum())
        log(f"phase {label}: {kind} [{C + 1}, {D}], n={slots.numel()}, "
            f"{rec['updated']} rows updated ({rec['fresh']} fresh): kernel "
            f"{rec['ms']:.4f} ms "
            f"({nbytes / rec['ms'] / 1e6:.1f} GB/s), plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({_pct(rec)}); max abs err {err}" + (
                f"; torch.optim.{'Adagrad' if kind == 'adagrad' else 'SparseAdam'}"
                f" {rec['library_ms']:.4f} ms (event-fenced), max abs row "
                f"difference from the kernel {rec['library_diff']:.3g}"
                if library else ""))
    del kv, pv, kt, pt
    return rec


def phase_apply_kernels() -> float:
    """(a) K2 and K3 against their plain versions at the headline shapes
    and at edge cases; returns the largest row error seen."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    max_err = 0.0

    def inputs(C1, D, n, drop=0.01, upd_share=0.9, new_share=0.2):
        """``upd_share`` "one" updates one row in each group of 32; with
        a share above 0, the last row the kernel may write (C - 1) is
        among the updated slots."""
        C = C1 - 1
        slots = torch.randperm(C, generator=gen, device=dev)[:n].to(
            torch.int32)
        k = int(n * drop)
        if k:
            slots[:k] = C                       # overflow / padding rows
            slots[k:2 * k] = C + 17             # above C
            slots[2 * k:3 * k] = -5             # negative
        grads = torch.randn(n, D, generator=gen, device=dev)
        if upd_share == "one":
            upd = torch.arange(n, device=dev) % 32 == 7
        else:
            upd = torch.rand(n, generator=gen, device=dev) < upd_share
        if n > 3 * k and upd_share != 0.0:
            if not bool((slots == C - 1).any()):
                slots[3 * k] = C - 1
            upd[slots == C - 1] = True
        is_new = torch.rand(n, generator=gen, device=dev) < new_share
        return slots, grads, upd, is_new

    for kind in ("adagrad", "adam"):
        for C1, D, n in ((4194305, 129, 131073), (524289, 65, 67265)):
            values = torch.randn(C1, D, generator=gen, device=dev)
            if kind == "adagrad":
                tables = [torch.rand(C1, D, generator=gen, device=dev) + 0.1]
                args = (0.05, 0.1)
            else:
                tables = [torch.randn(C1, D, generator=gen, device=dev) * 0.1,
                          torch.rand(C1, D, generator=gen, device=dev) * 0.1]
                args = (torch.tensor([0.01], device=dev), 0.9, 0.999, 1e-8)
            slots, grads, upd, is_new = inputs(C1, D, n)
            rec = compare_apply(kind, values, tables, slots, grads, upd,
                                is_new, args, "7 (a)", time_it=True)
            max_err = max(max_err, rec["max_abs_err"])
            # Edge cases: the edge widths; n below a warp and ragged
            # against K2's groups of 4 or 8 u-rows; update shares of
            # none, one row in 32 (most groups apply nothing), the
            # training path's ~26 %, half and all; no masks. Then on the
            # headline table: empty, every row dropped.
            for D2 in EDGE_WIDTHS:
                v2 = torch.randn(100003, D2, generator=gen, device=dev)
                t2 = [torch.rand(100003, D2, generator=gen, device=dev) + 0.1
                      for _ in tables]
                for n2, share in ((5, 1.0), (31, 0.26), (4099, 0.0),
                                  (4099, "one"), (4099, 0.26), (4099, 1.0),
                                  (77777, 0.5)):
                    s2, g2, u2, i2 = inputs(100003, D2, n2, drop=0.05,
                                            upd_share=share, new_share=0.5)
                    rec = compare_apply(kind, v2, t2, s2, g2, u2, i2, args,
                                        "7 (a) edge", time_it=False)
                    max_err = max(max_err, rec["max_abs_err"])
                rec = compare_apply(kind, v2, t2, s2, g2, None, None, args,
                                    "7 (a) edge", time_it=False)
                max_err = max(max_err, rec["max_abs_err"])
                del v2, t2
            empty = torch.zeros(0, dtype=torch.int32, device=dev)
            compare_apply(kind, values, tables, empty, grads[:0], None, None,
                          args, "7 (a) empty", time_it=False)
            dropped = torch.full((n,), C1 - 1, dtype=torch.int32, device=dev)
            compare_apply(kind, values, tables, dropped, grads, upd, is_new,
                          args, "7 (a) all dropped", time_it=False)
            del values, tables, slots, grads, upd, is_new
            torch.cuda.empty_cache()
    log(f"phase 7 (a): K2 and K3 match their plain versions on every case "
        f"(slot arrays equal, max abs row err {max_err})")
    return max_err


def _step_grads(tr, batch):
    """One step's lookup and row gradients, without the applies (on a
    mesh trainer's mesh: its exchanges included; an adaptive table's
    newly hot rows migrated)."""
    ts, group = tr.ts, tr.group
    mesh = getattr(tr, "mesh", None)
    _, gl = group.lookup_train(ts.ev, batch, ts.step, mesh)
    _, gl = group.migrate_adaptive(None, gl, ts.params)
    rows = {t: lk.rows.detach().requires_grad_() for t, lk in gl.lks.items()}
    params = {k: v.detach().requires_grad_() for k, v in ts.params.items()}
    out = tr.apply_fn(group.model_params(params),
                      group.combine(gl, rows, params), batch)
    per_ex = tr.loss_fn(out, batch)
    n_ranks = 1 if mesh is None else mesh.size
    grads = torch.autograd.grad(per_ex.sum() / (per_ex.shape[0] * n_ranks),
                                list(rows.values()))
    return gl, dict(zip(rows, grads))


def _step_applies(tr, kind, gl, grads):
    """Per table, the operands the step's sparse apply (``kind``) takes
    from the lookup ``gl`` and row gradients ``grads`` of
    :func:`_step_grads`: (values, slot tables, slots, grads, update,
    is_new, optimizer args, base rows or None), as the optimizer's
    ``_gate`` makes them."""
    from deeprec_tpu_torch.optimizers import sparse as sparse_lib
    o = tr.sparse_opt
    ops = []
    for tname, g in grads.items():
        lk = gl.lks[tname]
        upd, base = sparse_lib._gate(tr.group.tables[tname], lk)
        sl = tr.ts.slots[tname]
        if kind == "adagrad":
            tables = [sl["accum"]]
            args = (o.learning_rate, o.initial_accumulator_value)
        else:
            alpha = (o.learning_rate * torch.sqrt(1 - sl["beta2_power"])
                     / (1 - sl["beta1_power"])).reshape(1)
            tables = [sl["m"], sl["v"]]
            args = (alpha, o.beta1, o.beta2, o.epsilon)
        ops.append((tr.ts.ev[tname].values, tables, lk.slots,
                    g.contiguous(), upd, lk.is_new, args, base))
    return ops


def _table_shapes(tr) -> str:
    return ", ".join(
        f"[{cfg.capacity + 1}, {cfg.dim}] ({tr.ts.ev[t].values.numel() * 4} "
        f"bytes)" for t, cfg in tr.group.tables.items())


def _largest(calls, limit, size):
    """The ``limit`` calls of the largest ``size`` (all with None), in
    their order."""
    if limit is None or len(calls) <= limit:
        return calls
    keep = sorted(range(len(calls)), key=lambda i: -size(calls[i]))[:limit]
    return [calls[i] for i in sorted(keep)]


def _compare_step_kernels(tr, kind, label, batch, limit=None):
    """K1 on ``batch``'s own lookup operands, P1 on its probes (then on
    the same batch's probes again, every key present), P2 on its
    fresh-row draws and K2/K3 on its gradients, each against its plain
    version and timed; with ``limit``, each kernel on the ``limit``
    calls of largest operands (a model of many tables). K2/K3 of a
    dyn-dim or adaptive table update from its lookup's rows, for which
    no PyTorch call stands in (``library_ms`` null). Returns (fetch
    records, apply records, probe records, draw records)."""
    with captured_gathers() as calls, captured_probes() as probes, \
            captured_inits() as inits:
        gl, grads = _step_grads(tr, batch)
    calls = _largest(calls, limit, lambda a: a[1].numel() * a[0].shape[1])
    probes = _largest(probes, limit, lambda a: a[2].numel())
    inits = _largest(inits, limit, lambda a: a[2].numel() * a[0].shape[1])
    fetch = [compare_gather(f"{label} same lookup", *args)
             for args in calls]
    probe = compare_probes(f"{label} step's probe", probes)
    draws = [compare_init(f"{label} step's draw", *args) for args in inits]
    del calls, probes, inits
    recs = []
    for *ops, base in _largest(_step_applies(tr, kind, gl, grads), limit,
                               lambda o: o[3].numel()):
        recs.append(compare_apply(
            kind, *ops, f"{label} same gradients"
            + ("" if base is None else " (from the lookup's rows)"),
            time_it=True, library=base is None, base=base))
    del gl, grads
    with captured_probes() as probes:
        tr.group.lookup_train(tr.ts.ev, batch, tr.ts.step,
                              getattr(tr, "mesh", None))
    compare_probes(f"{label} same batch again",
                   _largest(probes, limit, lambda a: a[2].numel()))
    return fetch, recs, probe, draws


def phase_train(kind: str, label: str, warmup: int, steps: int,
                **build_kw):
    """(b)/(c) the headline training path with ``kind`` sparse optimizer
    ((f)/(g): another ``bench.build_wdl`` row through ``build_kw``):
    launch counts over the timed run, then K1 on one more step's own
    lookup operands and kernel vs plain applies from that step's
    gradients. Returns (trainer, run summary, apply records, fetch
    records, launches, probe records)."""
    from deeprec_tpu_torch import bench
    from deeprec_tpu_torch.ops.kernels import gather, hash_probe, init_rows
    from deeprec_tpu_torch.ops.kernels import occ_combine as occ
    from deeprec_tpu_torch.ops.kernels import sparse_apply as sa

    t0 = time.perf_counter()
    tr = bench.build_wdl(device="cuda", sparse_opt=kind, **build_kw)
    build_s = time.perf_counter() - t0
    kname = f"{kind}_apply_rows"
    gather.launches = 0                       # the main path starts here
    sa.launches[kname] = 0
    hash_probe.launches["find_or_insert"] = 0
    init_rows.launches = 0
    occ.launches = 0
    out = bench.bench_device(tr, warmup=warmup, steps=steps)
    launches = {"gather_rows": gather.launches,
                kname: sa.launches[kname],
                "occ_combine": occ.launches}  # the main path ends here
    if not build_kw.get("static_buckets"):    # static tables never probe
        launches["hash_probe_insert"] = hash_probe.launches["find_or_insert"]
        launches["init_fresh_rows"] = init_rows.launches
    if min(launches.values()) < 1:
        raise AssertionError(f"the training path did not launch every "
                             f"kernel: {launches}")
    log(f"phase {label}: {kind} {tr.metric} model built in {build_s:.3f} "
        f"s, tables {_table_shapes(tr)}; {warmup} + {steps} steps of "
        f"B={bench.BATCH}: {out['value']:.1f} samples/s "
        f"({out['step_ms']:.3f} ms/step); losses "
        f"{[round(x, 6) for x in out['losses']]}; n_overflow per step "
        f"{out['n_overflow']}; launches {launches}")

    batch = tr.next_batch()
    draws = []
    if kind == "adagrad" and not build_kw:    # the headline
        lookups_without_sync(label, tr.group, tr.ts.ev, unseen_batch(tr, 1),
                             step=tr.ts.step)
        ub = unseen_batch(tr, 2)
        capture_without_sync(
            label, "the lookups of a headline step on an unseen batch",
            lambda: tr.group.lookup_train(tr.ts.ev, ub, tr.ts.step))
        # P2 where every row of the batch is fresh.
        with captured_inits() as inits:
            tr.group.lookup_train(tr.ts.ev, unseen_batch(tr, 3), tr.ts.step)
        draws = [compare_init(f"{label} unseen batch's draw", *args)
                 for args in inits]
        del inits
    # The same gradients through the kernel and through the plain
    # version, on copies of the trained tables.
    fetch, recs, probes, step_draws = _compare_step_kernels(tr, kind, label,
                                                            batch)
    return tr, out, recs, fetch, launches, probes, draws + step_draws


def phase_checkpoint(tr, ckpt_dir: str):
    """(d) save the trained state in full, restore it, and score both."""
    from deeprec_tpu_torch.embedding import hash_table as ht
    from deeprec_tpu_torch.train.checkpoint import CheckpointManager
    from deeprec_tpu_torch.train.loop import make_eval_step

    t0 = time.perf_counter()
    mgr = CheckpointManager(ckpt_dir, tr.group)
    path = mgr.save(tr.ts)
    save_s = time.perf_counter() - t0
    names = set()
    for fn in os.listdir(path):
        if fn.endswith(".npz"):
            with np.load(os.path.join(path, fn)) as z:
                names.update(z.files)
    if ("slot/['accum']" not in names or not any(
            n.startswith("['dense_opt']/") for n in names)):
        raise AssertionError(f"checkpoint lacks optimizer state: "
                             f"{sorted(names)[:20]}")
    t0 = time.perf_counter()
    template = tr.ts.replace(ev={}, slots={t: {k: torch.zeros_like(v)
                                               for k, v in sl.items()}
                                           for t, sl in tr.ts.slots.items()})
    restored = mgr.restore(template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    batch = tr.next_batch()
    eval_step = make_eval_step(tr.group, tr.apply_fn)
    want = eval_step(tr.ts, batch)
    got = eval_step(restored, batch)
    if restored.step != tr.ts.step or not torch.equal(got, want):
        raise AssertionError(f"restored state scores differ: max abs "
                             f"{float((got - want).abs().max())}")
    # Rows and accumulators, key by key: the restored tables hold each
    # trained key at a slot of their own.
    for tname, st in tr.ts.ev.items():
        cfg = tr.group.tables[tname]
        live = torch.nonzero(ht.live_mask(st.table)).reshape(-1)
        kp = st.table.key_pair[live]
        rs = restored.ev[tname]
        at = ht.find(rs.table, kp[:, 0].contiguous(), kp[:, 1].contiguous(),
                     max_probes=cfg.max_probes).long()
        if not bool((at < cfg.capacity).all()):
            raise AssertionError(f"{tname}: keys missing after restore")
        for a, b in ((rs.values[at], st.values[live]),
                     (restored.slots[tname]["accum"][at],
                      tr.ts.slots[tname]["accum"][live])):
            if not torch.equal(a, b):
                raise AssertionError(f"{tname}: restored rows differ")
    for k, v in tr.ts.dense_opt["sum_of_squares"].items():
        if not torch.equal(restored.dense_opt["sum_of_squares"][k], v):
            raise AssertionError(f"dense_opt {k} differs after restore")
    log(f"phase 9 (d): checkpoint of step {tr.ts.step} saved in "
        f"{save_s:.3f} s ({sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))} "
        f"bytes), restored in {restore_s:.3f} s; eval scores of the "
        f"restored state equal the trained state's on {want.shape[0]} "
        f"rows; rows, accumulators and dense Adagrad state equal key by key")
    del restored, template


def phase_small():
    """(e) the __graft_entry__ sizes, three steps on the card and on the
    CPU from the same weights and batches."""
    from deeprec_tpu_torch import bench
    for kind in ("adagrad", "adam"):
        losses = {}
        for dev in ("cuda", "cpu"):
            tr = bench.build_small(dev, kind)
            ts = tr.ts
            got = []
            for _ in range(3):
                ts, m = tr.step(ts, tr.next_batch())
                got.append(float(m["loss"]))
            losses[dev] = got
        diff = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
        if not diff <= SMALL_LOSS_ATOL:
            raise AssertionError(f"(e) {kind}: card {losses['cuda']} vs CPU "
                                 f"{losses['cpu']}")
        log(f"phase 11 (e): {kind} small WDL, losses on the card "
            f"{losses['cuda']} and on the CPU {losses['cpu']}, max abs diff "
            f"{diff}")


def phase_static_serve_and_checkpoint(tr, ckpt_dir: str):
    """(f) a 512-row request from the trained static state through K1
    and through the plain gather; a full checkpoint round trip into
    fresh tables; the same request served from that checkpoint."""
    from deeprec_tpu_torch.ops.kernels import gather
    from deeprec_tpu_torch.serving.processor import ServingModel
    from deeprec_tpu_torch.train.checkpoint import CheckpointManager
    from deeprec_tpu_torch.train.loop import make_eval_step

    raw = tr.data.next_batch_np(wide=tr.wide)
    req = tr.group.pack_batch_np({k: v[:512] for k, v in raw.items()},
                                 tr.device)
    eval_step = make_eval_step(tr.group, tr.apply_fn)
    out = eval_step(tr.ts, req)
    kernel_fn = gather.gather_rows
    gather.gather_rows = gather.gather_rows_reference
    try:
        plain = eval_step(tr.ts, req)
    finally:
        gather.gather_rows = kernel_fn
    if out.shape != (512,) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"static request: bad logits {out.shape}")
    if not torch.equal(out, plain):
        raise AssertionError(f"static request: kernel vs plain gather, max "
                             f"abs diff {float((out - plain).abs().max())}")
    log("phase 12 (f): 512-row request from the trained static state: "
        "kernel path vs plain gather, identical logits")

    t0 = time.perf_counter()
    mgr = CheckpointManager(ckpt_dir, tr.group)
    path = mgr.save(tr.ts)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path))
    t0 = time.perf_counter()
    template = tr.ts.replace(ev={}, slots=tr.group.init_optimizer(
        tr.sparse_opt, tr.device))
    restored = mgr.restore(template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    for tname, st in tr.ts.ev.items():
        if not (torch.equal(restored.ev[tname].values, st.values)
                and torch.equal(restored.slots[tname]["accum"],
                                tr.ts.slots[tname]["accum"])):
            raise AssertionError(f"{tname}: restored static rows or "
                                 f"accumulators differ")
    del restored, template
    log(f"phase 12 (f): static checkpoint of step {tr.ts.step} saved in "
        f"{save_s:.3f} s ({nbytes} bytes), restored into fresh tables in "
        f"{restore_s:.3f} s; rows and accumulators equal")
    serving = ServingModel(tr.group, tr.apply_fn, tr.ts, ckpt_dir)
    serving.full_update()
    served = serving.predict(req)
    if not torch.equal(served, out):
        raise AssertionError(f"served static model: max abs diff "
                             f"{float((served - out).abs().max())}")
    log("phase 12 (f): ServingModel restored the static model; its scores "
        "equal the trained state's")


def phase_e2e(tmp: str):
    """(h) the e2e row: TSV, parse and pack checks, the timed pipeline
    with launch counts, and K1/K2 on one of its batches."""
    from deeprec_tpu_torch import bench, native
    from deeprec_tpu_torch.data import criteo
    from deeprec_tpu_torch.embedding import variable as ev
    from deeprec_tpu_torch.feature_column.feature_column import batch_to
    from deeprec_tpu_torch.ops.kernels import gather, hash_probe, init_rows
    from deeprec_tpu_torch.ops.kernels import occ_combine as occ
    from deeprec_tpu_torch.ops.kernels import sparse_apply as sa

    path = os.path.join(tmp, "criteo.tsv")
    n_rows = E2E_BATCHES * BATCH
    t0 = time.perf_counter()
    bench.write_tsv(path, n_rows, criteo.SyntheticCriteo(
        BATCH, vocab=200_000, seed=7))
    log(f"phase 14 (h): wrote {n_rows} TSV rows ({os.path.getsize(path)} "
        f"bytes) in {time.perf_counter() - t0:.3f} s")

    with open(path) as f:
        lines = [next(f) for _ in range(1000)]
    py = criteo.parse_criteo_lines(lines)
    rows, labels, dense, cats, _ = native.parse_criteo(
        "".join(lines).encode(), 1000)
    ulp = np.spacing(np.maximum(np.abs(py[1]), np.abs(dense[:rows])))
    if not (rows == 1000 and np.array_equal(py[0], labels)
            and np.array_equal(py[2], cats)
            and bool((np.abs(py[1] - dense) <= ulp).all())):
        raise AssertionError("native parse differs from the Python parser")
    log(f"phase 14 (h): native parse of 1000 lines equals the Python "
        f"parser's (labels, ids; numerics within one ulp, "
        f"{int((py[1] != dense).sum())} of {dense.size} differ by one)")

    t0 = time.perf_counter()
    tr = bench.build_wdl(device="cuda")
    raw = next(criteo.criteo_file_batches(path, BATCH, as_numpy=True,
                                          wide=False, id_bits=31))
    compact = batch_to(tr.group.pack_batch_np(raw, "cpu", compact=True),
                       tr.device)
    full = tr.group.pack_batch_np(raw, tr.device)
    for tname, tcols in tr.group._columns_by_table().items():
        a = tr.group._packed_view(compact, tname, tcols)
        b = tr.group._packed_view(full, tname, tcols)
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"{tname}: compact pack unpacks to other "
                                 f"ids than the full pack")
    log(f"phase 14 (h): compact pack of the first batch unpacks on the card "
        f"to the full pack's (hi, lo) planes ({len(tr.group.tables)} "
        f"tables); headline model built in {time.perf_counter() - t0:.3f} s")

    gather.launches = 0                       # the e2e path starts here
    sa.launches["adagrad_apply_rows"] = 0
    hash_probe.launches["find_or_insert"] = 0
    init_rows.launches = 0
    occ.launches = 0
    out = bench.bench_e2e(tr, n_rows=n_rows, path=path)
    launches = {"gather_rows": gather.launches,
                "adagrad_apply_rows": sa.launches["adagrad_apply_rows"],
                "hash_probe_insert": hash_probe.launches["find_or_insert"],
                "init_fresh_rows": init_rows.launches,
                "occ_combine": occ.launches}
    if min(launches.values()) < 1:            # the e2e path ends here
        raise AssertionError(f"the e2e path did not launch every kernel: "
                             f"{launches}")
    log(f"phase 14 (h): e2e pipeline, {out['steps']} timed steps of "
        f"B={BATCH}: {out['value']:.1f} samples/s ({out['step_ms']:.3f} "
        f"ms/step); losses {[round(x, 6) for x in out['losses']]}; "
        f"n_overflow per step {out['n_overflow']}; live keys per table "
        f"{[int(ev.num_live(st)) for st in tr.ts.ev.values()]}; launches "
        f"{launches}")
    batches = bench.e2e_batches(tr, path)
    batch = batch_to(next(batches), tr.device)
    lookups_without_sync("14 (h)", tr.group, tr.ts.ev,
                         batch_to(next(batches), tr.device), step=tr.ts.step)
    fetch, recs, probes, draws = _compare_step_kernels(tr, "adagrad",
                                                       "14 (h)", batch)
    return fetch, recs, launches, probes, draws


def phase_probe(device="cuda", capacity: int = 1 << 19,
                n: int = 294912) -> dict:
    """(i) P1 against its plain version on every case of
    ``tests/torch_probe_cases.py`` (the CPU tests' cases), then on a
    65-wide table of the headline's capacity (2**19 slots) fed batches
    of 294,912 unseen ids until it is full (or FULL_TABLE_BATCHES were
    fed), timed on the next batch (almost no id finds a free slot) and
    on a lookup of it.
    Returns the full-table insert record."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_probe_cases as pc
    from deeprec_tpu_torch.embedding import hash_table as ht
    from deeprec_tpu_torch.utils import keys as keylib
    dev = torch.device(device)

    def ids_of(a):
        hi, lo = keylib.split_ids(np.asarray(a, np.int64))
        return torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev)

    t0 = time.perf_counter()
    n_ops = 0
    for name, (cap, ops) in pc.cases().items():
        table = ht.create(cap, dev)
        for op in ops:
            n_ops += 1
            if op[0] == "remove":
                table.key_rows.copy_(torch.from_numpy(pc.tombstone(
                    table.key_rows.cpu().numpy(), op[1])).to(dev))
                continue
            hi, lo = ids_of(op[1])
            mask = (torch.from_numpy(op[2]).to(dev) if op[0] == "insert"
                    else None)
            compare_probe(f"15 (i) {name}", op[0], table.key_rows.clone(),
                          hi, lo, mask, 64, time_it=False)
            if op[0] == "insert":
                ht.find_or_insert(table, hi, lo, mask)
    log(f"phase 15 (i): P1 equal to its plain version on "
        f"{len(pc.cases())} cases, {n_ops} operations "
        f"({time.perf_counter() - t0:.3f} s)")

    rng = np.random.default_rng(11)
    table = ht.create(capacity, dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    live, b = 0, 0
    while True:
        hi, lo = ids_of(rng.integers(1, 2**62, size=n))
        last = live == capacity or b == FULL_TABLE_BATCHES
        rec = compare_probe(f"15 (i) 65-wide batch {b}", "insert",
                            table.key_rows.clone(), hi, lo, mask, 64,
                            time_it=last)
        ht.find_or_insert(table, hi, lo, mask)
        live = int(ht.live_mask(table).sum())
        log(f"phase 15 (i): 65-wide table batch {b}: {rec['new']} inserted, "
            f"the kernel ran {rec['rounds']} rounds (the plain version "
            f"{rec['plain_rounds']}), {live} of {capacity} slots live")
        if last:
            compare_probe("15 (i) 65-wide table", "find", table.key_rows,
                          hi, lo, None, 64)
            hi, lo = ids_of(rng.integers(1, 2**62, size=n))
            capture_without_sync(
                "15 (i)", "find_or_insert of unseen ids into the full table "
                "(the kernel stops at its first all-dead round)",
                lambda: ht.find_or_insert(table, hi, lo, mask))
            return rec
        b += 1


def phase_optimizers():
    """(j) the headline path with each optimizer beyond Adagrad and
    Adam, a few full-width steps each; AdamAsync must launch K3, every
    one P1."""
    from deeprec_tpu_torch import bench
    from deeprec_tpu_torch.ops.kernels import hash_probe
    from deeprec_tpu_torch.ops.kernels import sparse_apply as sa
    from deeprec_tpu_torch.optimizers import sparse as sopt
    opts = {"sgd": sopt.SparseSGD(),
            "adagrad_decay": sopt.SparseAdagradDecay(),
            "adam_async": sopt.SparseAdamAsync(),
            "adam_async_original": sopt.SparseAdamAsync(
                apply_sparse_adam=False),
            "ftrl": sopt.SparseFtrl(), "ftrl_v2": sopt.SparseFtrlV2()}
    for name, opt in opts.items():
        tr = bench.build_wdl(device="cuda", sparse_opt=opt)
        sa.launches["adam_apply_rows"] = 0    # this path starts here
        hash_probe.launches["find_or_insert"] = 0
        out = bench.bench_device(tr, *OPT_STEPS)
        launches = {"hash_probe_insert": hash_probe.launches["find_or_insert"],
                    "adam_apply_rows": sa.launches["adam_apply_rows"]}
        if launches["hash_probe_insert"] < 1 or (
                name.startswith("adam_async")
                and launches["adam_apply_rows"] < 1):  # and ends here
            raise AssertionError(f"(j) {name}: launches {launches}")
        log(f"phase 16 (j): {name}: {sum(OPT_STEPS)} headline steps, "
            f"{out['value']:.1f} samples/s ({out['step_ms']:.3f} ms/step) "
            f"over the last {OPT_STEPS[1]}; losses "
            f"{[round(x, 6) for x in out['losses']]}; launches {launches}")
        del tr
        _release()


def phase_fused_and_repeat():
    """(k) the headline model trained twice from the same state on the
    same 5 batches: whether losses and tables are bit-equal is logged,
    not gated (ROADMAP fault 3.2). (l) the fused combine
    (``combine_tables`` + ``apply_fn_fused``) against the dict path for
    3 steps on those batches: a trainer's state and model, with a step
    made with ``combine_fn=group.combine_tables`` and the fused
    apply; then the step time of both, in turns."""
    from deeprec_tpu_torch import bench
    from deeprec_tpu_torch.models import wdl
    from deeprec_tpu_torch.train.loop import make_train_step

    def run(tr, raws):
        ts, losses = tr.ts, []
        for raw in raws:   # each group packs its own batch
            ts, m = tr.step(ts, tr.group.pack_batch_np(raw, tr.device))
            losses.append(m["loss"])
        tr.ts = ts
        return [float(x) for x in losses]

    a = bench.build_wdl(device="cuda")
    raws = [a.data.next_batch_np(wide=a.wide) for _ in range(REPEAT_STEPS)]
    la = run(a, raws)
    b = bench.build_wdl(device="cuda")
    lb = run(b, raws)
    short = {t: f"{t.split(':')[0]}[{st.values.shape[1]}]"
             for t, st in a.ts.ev.items()}
    same = {short[t]: torch.equal(st.values, b.ts.ev[t].values)
            for t, st in a.ts.ev.items()}
    diff = {short[t]: float((st.values - b.ts.ev[t].values).abs().max())
            for t, st in a.ts.ev.items()}
    log(f"phase 17 (k): two runs of {REPEAT_STEPS} headline steps from the "
        f"same state: losses {'bit-equal' if la == lb else 'differ'} "
        f"({la} vs {lb}); tables bit-equal {same}; max abs row "
        f"difference {diff}")
    del b
    _release()
    f = bench.build_wdl(device="cuda")
    f.step = make_train_step(f.group, wdl.apply_fn_fused(f.model, f.group),
                             f.loss_fn, f.sparse_opt, f.dense_opt,
                             combine_fn=f.group.combine_tables)
    lf = run(f, raws[:FUSED_STEPS])
    rel = [abs(x - y) / abs(y) for x, y in zip(lf, la)]
    log(f"phase 18 (l): fused combine vs dict path, {FUSED_STEPS} headline "
        f"steps: losses {lf} vs {la[:FUSED_STEPS]}, relative differences "
        f"{rel}")
    if not max(rel) <= FUSED_LOSS_RTOL:
        raise AssertionError(f"(l) fused vs dict losses differ by {rel}")
    # Step time of each path, in turns (dict, fused, fused, dict) on the
    # same batches: the first run of each takes them unseen, the second
    # seen.
    more = [a.data.next_batch_np(wide=a.wide) for _ in range(8)]
    packed = {id(t): [t.group.pack_batch_np(r, t.device) for r in more]
              for t in (a, f)}

    def timed(tr):
        ts, batches = tr.ts, packed[id(tr)]
        warm, steps = FUSED_TIMED_STEPS
        for b in batches[:warm]:
            ts, _ = tr.step(ts, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            ts, _ = tr.step(ts, batches[(warm + i) % len(batches)])
        torch.cuda.synchronize()
        tr.ts = ts
        return (time.perf_counter() - t0) / steps * 1e3

    ms = [(name, timed(tr)) for name, tr in
          (("dict", a), ("fused", f), ("fused", f), ("dict", a))]
    log(f"phase 18 (l): mean step ms over {FUSED_TIMED_STEPS[1]} steps "
        f"after {FUSED_TIMED_STEPS[0]}, in turns: "
        + ", ".join(f"{name} {t:.3f}" for name, t in ms))
    del a, f
    _release()


def _train_zoo():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_zoo_torch
    return train_zoo_torch


def _live_rows(group, states) -> dict:
    """Per table, the live keys' (keys, values, freqs, versions) sorted
    by key, and the CBF counters, on the host."""
    from deeprec_tpu_torch.embedding import variable as ev
    out = {}
    for tname, cfg in group.tables.items():
        a = ev.export_arrays(cfg, states[tname])
        order = np.argsort(a["keys"])
        out[tname] = {k: (v[order] if k != "bloom" else v)
                      for k, v in a.items()}
    return out


def _n_live(states) -> int:
    from deeprec_tpu_torch.embedding import variable as ev
    return sum(int(ev.num_live(st)) for st in states.values())


def phase_ev_cbf(tmp: str, device="cuda"):
    """(m) the WDL --ev training run: tools/train_zoo_torch.py at full
    width (8 steps, then a resumed run to 10), launch counts reset just
    before and read just after; then the same model in process through
    the Estimator and a CheckpointManager: the CBF step timed, its
    lookups without a host sync, a full save at step 6 after a shrink,
    steps to 8, a shrink and an incremental save with tombstones; a fresh
    restore equal to the live state, a ServingModel delta that drops an
    evicted key, and every kernel of the path against its plain version
    on the path's operands."""
    import types

    from deeprec_tpu_torch.embedding import hash_table as ht
    from deeprec_tpu_torch.embedding import lookup as lkup
    from deeprec_tpu_torch.embedding import variable as ev
    from deeprec_tpu_torch.ops.kernels import gather, hash_probe, init_rows
    from deeprec_tpu_torch.ops.kernels import occ_combine as occ
    from deeprec_tpu_torch.ops.kernels import sparse_apply as sa
    from deeprec_tpu_torch.optimizers import sparse as sopt
    from deeprec_tpu_torch.serving.processor import ServingModel
    from deeprec_tpu_torch.train import loop as trainlib
    from deeprec_tpu_torch.utils import keys as keylib

    tz = _train_zoo()
    label = "19 (m)"
    dev = torch.device(device)
    argv = EV_CBF_ARGS + ["--checkpoint", os.path.join(tmp, "tool")] + (
        ["--cpu"] if dev.type == "cpu" else [])
    gather.launches = 0                       # the main path starts here
    sa.launches["adagrad_apply_rows"] = 0
    hash_probe.launches["find_or_insert"] = 0
    hash_probe.launches["find"] = 0
    init_rows.launches = 0
    occ.launches = 0
    t0 = time.perf_counter()
    runs = [tz.main(argv + ["--steps", "8"])]
    _release()
    runs.append(tz.main(argv + ["--steps", "10"]))
    launches = {"gather_rows": gather.launches,
                "adagrad_apply_rows": sa.launches["adagrad_apply_rows"],
                "hash_probe_insert": hash_probe.launches["find_or_insert"],
                "hash_probe_find": hash_probe.launches["find"],
                "init_fresh_rows": init_rows.launches,
                "occ_combine": occ.launches}  # the main path ends
    tool_s = time.perf_counter() - t0
    _release()
    if min(launches.values()) < 1:
        raise AssertionError(f"the ev_cbf path did not launch every kernel: "
                             f"{launches}")
    for r in runs:
        if not (np.isfinite(r["final_loss"]) and 0 < r["auc"] < 1):
            raise AssertionError(f"ev_cbf run: {r}")
    if runs[1].get("resumed_from") != 8 or runs[1]["steps"] != 10:
        raise AssertionError(f"the second run did not resume at 8: {runs[1]}")
    log(f"phase {label}: tools/train_zoo_torch.py {' '.join(EV_CBF_ARGS)}: "
        f"8 steps (loss {runs[0]['final_loss']}, auc {runs[0]['auc']}), "
        f"then resumed from {runs[1]['resumed_from']} to 10 (loss "
        f"{runs[1]['final_loss']}, auc {runs[1]['auc']}) in {tool_s:.3f} s "
        f"with saves, restore and eval; launches {launches}")

    # The same model in process.
    args = tz.parse_args(EV_CBF_ARGS + ["--checkpoint",
                                        os.path.join(tmp, "est")])
    est, make_data, pack, _ = tz.build(args, dev)
    group, mgr = est.group, est.manager
    data = make_data(args.seed)
    batches = [pack(data) for _ in range(9)]
    warm, timed = EV_CBF_STEPS
    est.train(iter(batches), warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.train(iter(batches[warm:]), warm + timed)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / timed

    def shrink(step):
        before = _n_live(est.ts.ev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        est.ts = mgr.shrink_tables(est.ts, step)
        torch.cuda.synchronize()
        return time.perf_counter() - t, before - _n_live(est.ts.ev)

    def timed_save(**kw):
        t = time.perf_counter()
        path = mgr.save(est.ts, **kw)
        return time.perf_counter() - t, path

    shrink6_s, evicted6 = shrink(6)
    save6_s, full6 = timed_save()
    est.train(iter(batches[6:8]), 8)
    shrink8_s, evicted8 = shrink(8)
    save8_s, incr8 = timed_save(incremental=True, since_step=6)
    if not (evicted6 > 0 and evicted8 > 0):
        raise AssertionError(f"the shrinks evicted {evicted6} and {evicted8} "
                             f"keys")
    tombs = {}
    for fn in os.listdir(incr8):
        if fn.startswith("table-"):
            with np.load(os.path.join(incr8, fn)) as z:
                tombs[fn[len("table-"):-len("-s0.npz")]] = z["tombstones"]
    if not any(t.size for t in tombs.values()):
        raise AssertionError("the incremental save carries no tombstones")
    live = _live_rows(group, est.ts.ev)

    # A fresh restore: full-6, then incr-8 with its tombstones replayed.
    est2, _, _, _ = tz.build(args, dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    got_step = est2.restore_if_available()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    back = _live_rows(group, est2.ts.ev)
    for tname, want in live.items():
        for k, v in want.items():
            if not np.array_equal(back[tname][k], v):
                raise AssertionError(f"restore {tname}: {k} differs from the "
                                     f"live state at step 8")
    if got_step != 8:
        raise AssertionError(f"restored step {got_step}, not 8")
    serve_tmpl = trainlib.create_train_state(
        group, {k: v.clone() for k, v in est2.ts.params.items()}, device=dev)
    apply_fn = est2.apply_fn
    del est2
    _release()

    # Serving: full-6, then the delta with its tombstones.
    serving = ServingModel(group, apply_fn, serve_tmpl, mgr.dir)
    serving.full_update(step=6)
    tname = max(group.tables, key=lambda t: group.tables[t].dim)
    cfg = group.tables[tname]
    with np.load(os.path.join(full6, f"table-{tname}-s0.npz")) as z:
        gone = np.intersect1d(tombs[tname], z["keys"])[:1]
    if gone.size != 1:
        raise AssertionError("no key of full-6 among the tombstones")
    hi, lo = keylib.split_ids(gone)
    qhi, qlo = torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev)
    before = ev.lookup(cfg, serving._ts.ev[tname], qhi, qlo)
    with captured_probes(clone_finds=True) as replay:
        t = time.perf_counter()
        version = serving.delta_update()
        torch.cuda.synchronize()
        delta_s = time.perf_counter() - t
    after = ev.lookup(cfg, serving._ts.ev[tname], qhi, qlo)
    if (version != 8 or not bool((before != 0).any())
            or not torch.equal(after, serving._ts.ev[tname].default_bank[:1])):
        raise AssertionError(f"serving delta: version {version}; the evicted "
                             f"key read {before} before and {after} after")
    finds = [c for c in replay if c[0] == "find"]
    compare_probes(f"{label} delta replay", replay, time_it=False)
    del serving, serve_tmpl
    _release()

    # The kernels on the path's operands: the step after the shrink at 8
    # (tables with tombstones), then the eval lookups' finds.
    tr = types.SimpleNamespace(
        ts=est.ts, group=group, apply_fn=est.apply_fn, loss_fn=est.loss_fn,
        sparse_opt=sopt.SparseAdagrad(learning_rate=args.learning_rate))
    fetch, applies, probes, draws = _compare_step_kernels(
        tr, "adagrad", label, batches[8])
    eval_batch = pack(make_data(args.seed + 10_001))
    with captured_probes() as evals:
        est.predict(eval_batch)
    find_recs = compare_probes(f"{label} eval", evals)

    # No host sync in the CBF step's lookups.
    raw = data.next_batch_np(wide=True)
    ub = group.pack_batch_np(
        {k: v + (1 << 56) if k.startswith("C") else v
         for k, v in raw.items()}, dev)
    lookups_without_sync(label, group, est.ts.ev, ub, step=est.ts.step)
    capture_without_sync(label, "the CBF step's lookups (dedup, counters, "
                         "P1, P2, K1) on an unseen batch",
                         lambda: group.lookup_train(est.ts.ev, ub,
                                                    est.ts.step))

    # dedup against lookup_train_occ's claim dedup, on the widest
    # table's ids of one batch.
    tcols = group._columns_by_table()[tname]
    fhi, flo, _ = group._packed_view(batches[8], tname, tcols)
    fhi, flo = fhi.reshape(-1).contiguous(), flo.reshape(-1).contiguous()
    slots = ht.find(est.ts.ev[tname].table, fhi, flo)
    real = fhi != keylib.EMPTY_HI
    dedup_ms = median_ms(lambda: lkup.dedup(fhi, flo))
    claim_ms = median_ms(lambda: ev.claim_dedup(slots, real, cfg.capacity))
    sizes = {t: sum(os.path.getsize(os.path.join(p, f))
                    for f in os.listdir(p)) for t, p in (("full-6", full6),
                                                        ("incr-8", incr8))}
    log(f"phase {label}: {CARD['smi']}: CBF step {step_s * 1e3:.3f} ms "
        f"({BATCH / step_s:.1f} samples/s) over {timed} steps after "
        f"{warm}; dedup of the {cfg.dim}-wide table's {fhi.numel()} ids "
        f"{dedup_ms:.4f} ms device time, lookup_train_occ's claim dedup on "
        f"the same ids {claim_ms:.4f} ms; shrink at 6: {evicted6} keys "
        f"evicted in {shrink6_s * 1e3:.3f} ms, at 8: {evicted8} in "
        f"{shrink8_s * 1e3:.3f} ms (journal included); full save "
        f"{save6_s:.3f} s ({sizes['full-6']} bytes), incremental "
        f"{save8_s:.3f} s ({sizes['incr-8']} bytes, "
        f"{sum(t.size for t in tombs.values())} tombstones); fresh restore "
        f"(full-6 + incr-8) {restore_s:.3f} s, equal to the live state at "
        f"step 8 (keys, rows, freqs, versions, counters); serving delta "
        f"{delta_s:.3f} s ({len(finds)} P1 finds in the replay), the evicted "
        f"key reads the default row")
    del est, tr, batches
    _release()
    return launches, fetch, applies, probes, draws, find_recs


def _state_tensors(x, path=""):
    """(path, tensor) of every tensor of a train state, in order."""
    if isinstance(x, torch.Tensor):
        yield path, x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _state_tensors(v, f"{path}/{k}")
    elif hasattr(x, "__dataclass_fields__"):
        for k in x.__dataclass_fields__:
            yield from _state_tensors(getattr(x, k), f"{path}.{k}")


def _states_equal(a, b, label: str, what: str) -> int:
    """Every tensor of two train states bit-equal, else the first that
    differs is named; returns the count of tensors compared."""
    n = 0
    for (p, x), (_, y) in zip(_state_tensors(a), _state_tensors(b)):
        n += 1
        if not torch.equal(x, y):
            raise AssertionError(
                f"phase {label}: {what} differ first at {p}: max abs "
                f"difference {float((x.double() - y.double()).abs().max())}")
    return n


def _epoch_launch_counts(kind):
    from deeprec_tpu_torch.ops.kernels import gather, hash_probe, init_rows
    from deeprec_tpu_torch.ops.kernels import sparse_apply as sa
    return {"gather_rows": gather.launches,
            f"{kind}_apply_rows": sa.launches[f"{kind}_apply_rows"],
            "hash_probe_insert": hash_probe.launches["find_or_insert"],
            "init_fresh_rows": init_rows.launches}


def _reset_launch_counts(kind):
    from deeprec_tpu_torch.ops.kernels import gather, hash_probe, init_rows
    from deeprec_tpu_torch.ops.kernels import sparse_apply as sa
    gather.launches = 0
    sa.launches[f"{kind}_apply_rows"] = 0
    hash_probe.launches["find_or_insert"] = 0
    init_rows.launches = 0


def eager_vs_graph(tr, pool, n_epochs: int, kind: str, label: str):
    """``tr.ts`` trained on ``pool`` for ``n_epochs`` twice: a copy by
    the eager loop (each step synchronized and timed), ``tr.ts`` itself
    by the captured ``make_epoch_step``, with the launch counts reset
    just before that call and read just after. Losses and every state
    tensor must be bit-equal. Returns (the eager run's state, launches,
    {graph replays, device ms a replayed step, eager median ms})."""
    from deeprec_tpu_torch.train import loop

    eager = loop.clone_state(tr.ts)
    want, ms = [], []
    for _ in range(n_epochs):
        for b in pool:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eager, m = tr.step(eager, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            want.append(m["loss"])
    want = torch.stack(want)
    epoch = loop.make_epoch_step(tr.group, tr.apply_fn, tr.loss_fn,
                                 tr.sparse_opt, tr.dense_opt,
                                 n_epochs=n_epochs)
    stacked = loop.stack_batches(pool)
    torch.cuda.synchronize()
    _reset_launch_counts(kind)                # the main path starts here
    t0 = time.perf_counter()
    tr.ts, losses = epoch(tr.ts, stacked)
    launches = _epoch_launch_counts(kind)     # the main path ends here
    replay_ms = epoch.replay_ms()
    call_s = time.perf_counter() - t0
    run = epoch.last_run
    if min(launches.values()) < 1:
        raise AssertionError(f"phase {label}: the captured epoch did not "
                             f"launch every kernel: {launches}")
    shape = (len(pool),) if n_epochs == 1 else (n_epochs, len(pool))
    if tuple(losses.shape) != shape or not torch.equal(
            losses.reshape(-1), want):
        raise AssertionError(f"phase {label}: captured losses "
                             f"{losses.tolist()} != eager {want.tolist()}")
    if not torch.isfinite(losses).all():
        raise FloatingPointError(f"phase {label}: losses {losses.tolist()}")
    if tr.ts.step != eager.step:
        raise AssertionError(f"phase {label}: steps {tr.ts.step} vs "
                             f"{eager.step}")
    paths = _states_equal(tr.ts, eager, label,
                          "the captured epoch and the eager loop")
    n = run["steps"]
    stats = {"replays": run["replays"],
             "replay_ms": replay_ms / run["replays"],
             "eager_ms": float(np.median(ms))}
    log(f"phase {label}: {kind}, {n_epochs} x {len(pool)} steps of "
        f"B={loop._pool_size(pool[0])}: the "
        f"captured epoch equals the eager loop bit for bit (losses "
        f"{[round(x, 6) for x in losses.reshape(-1).tolist()]}, "
        f"{paths} state tensors); eager median synchronized step "
        f"{float(np.median(ms)):.3f} ms (min {min(ms):.3f}); graph "
        f"{run['replays']} replays, {replay_ms / run['replays']:.3f} ms a "
        f"step (CUDA events, back to back), host enqueue "
        f"{run['enqueue_s'] / run['replays'] * 1e3:.4f} ms a step, 0 host "
        f"syncs between the first and the last replay (they ran under "
        f"set_sync_debug_mode('error')); the whole call {call_s:.3f} s "
        f"(step 0 eager, capture, replays); wrapper launches (step 0 and "
        f"the capture) {launches}")
    return eager, launches, stats


def _within(a, b, rtol, atol):
    """(whether ``a`` is within ``rtol``/``atol`` of ``b``, max abs
    difference)."""
    d = (a.double() - b.double()).abs()
    return (bool((d <= atol + rtol * b.double().abs()).all()),
            float(d.max()) if d.numel() else 0.0)


def micro_vs_full(tr, ts, label: str):
    """One ``micro_batch_num=MICRO_BATCHES`` step from a copy of ``ts``
    against the full-batch step from ``ts``, on a new batch."""
    from deeprec_tpu_torch.train import loop

    micro = loop.make_train_step(tr.group, tr.apply_fn, tr.loss_fn,
                                 tr.sparse_opt, tr.dense_opt,
                                 micro_batch_num=MICRO_BATCHES)
    mts = loop.clone_state(ts)
    b = tr.next_batch()
    out = {}
    for name, step, state in (("micro", micro, mts), ("full", tr.step, ts)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        out[name] = (state, m, (time.perf_counter() - t0) * 1e3)
    (mts, mm, m_ms), (fts, fm, f_ms) = out["micro"], out["full"]
    lm, lf = float(mm["loss"]), float(fm["loss"])
    errs = {}
    for tname, st in fts.ev.items():
        if not torch.equal(st.table.key_rows, mts.ev[tname].table.key_rows):
            raise AssertionError(f"phase {label}: key rows differ")
        for what, a, w in (("values", mts.ev[tname].values, st.values),
                           ("accum", mts.slots[tname]["accum"],
                            fts.slots[tname]["accum"])):
            errs[f"{tname.split(':')[0]}.{what}"] = _within(
                a, w, MICRO_RTOL, MICRO_ATOL)
    for k, v in fts.params.items():
        errs[k] = _within(mts.params[k], v, MICRO_RTOL, MICRO_ATOL)
    bad = {k: e for k, (ok, e) in errs.items() if not ok}
    overflow = (int(mm["n_overflow"]), int(fm["n_overflow"]))
    table_err = max(e for k, (_, e) in errs.items() if k not in fts.params)
    param_err = max(e for k, (_, e) in errs.items() if k in fts.params)
    log(f"phase {label}: micro_batch_num={MICRO_BATCHES} step {m_ms:.3f} ms "
        f"against the full-batch step {f_ms:.3f} ms (synchronized, one "
        f"step each): loss {lm:.8f} vs {lf:.8f} (relative "
        f"{abs(lm - lf) / abs(lf):.3e}); largest abs differences: tables "
        f"{table_err:.3e}, dense params {param_err:.3e}; n_overflow "
        f"{overflow}")
    if abs(lm - lf) > MICRO_LOSS_RTOL * abs(lf) or bad or any(overflow):
        raise AssertionError(f"phase {label}: the micro-batched step is "
                             f"outside its tolerances: loss {lm} vs {lf}, "
                             f"{bad}, n_overflow {overflow}")
    # The first step of each ran shapes new to the process; time more,
    # each on its own state, in turns.
    times = {"micro": [], "full": []}
    for _ in range(MICRO_TIMED_STEPS):
        b = tr.next_batch()
        for name, step in (("micro", micro), ("full", tr.step)):
            state = mts if name == "micro" else fts
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, b)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"phase {label}: median synchronized step over "
        f"{MICRO_TIMED_STEPS} more steps, in turns: micro_batch_num="
        f"{MICRO_BATCHES} {med['micro']:.3f} ms, full batch "
        f"{med['full']:.3f} ms")
    return med["micro"]


def phase_epoch(gather_err: float, apply_err: float):
    """(n) the captured epoch step at full width; see the module's
    docstring. Returns the kernels' records of the ``epoch`` path."""
    from deeprec_tpu_torch import bench
    from deeprec_tpu_torch.optimizers import dense as dense_lib
    from deeprec_tpu_torch.optimizers import sparse as sparse_lib
    from deeprec_tpu_torch.train import loop

    label = "20 (n)"
    tr = bench.build_wdl(device="cuda")
    pool = [tr.next_batch() for _ in range(EPOCH_POOL)]
    start = loop.clone_state(tr.ts)
    eager, launches, stats = eager_vs_graph(tr, pool, EPOCH_EPOCHS,
                                            "adagrad", label)
    replays = stats["replays"]
    micro_vs_full(tr, eager, label)
    del eager
    # The kernels on the operands of the epoch's first step: the pool's
    # first batch on the state the epoch started from (every key new).
    tr.ts = start
    fetch, applies, probes, draws = _compare_step_kernels(
        tr, "adagrad", f"{label} first pool batch", pool[0])
    del tr, start, pool
    _release()

    tr = bench.build_wdl(device="cuda", sparse_opt=sparse_lib.SparseAdam())
    tr.dense_opt = dense_lib.Adam(2e-3)
    tr.ts.dense_opt = tr.dense_opt.init(tr.ts.params)
    tr.step = loop.make_train_step(tr.group, tr.apply_fn, tr.loss_fn,
                                   tr.sparse_opt, tr.dense_opt)
    pool = [tr.next_batch() for _ in range(EPOCH_ADAM_POOL)]
    start = loop.clone_state(tr.ts)
    _, adam_launches, adam_stats = eager_vs_graph(tr, pool, 1, "adam",
                                                  f"{label} Adam")
    adam_replays = adam_stats["replays"]
    powers = {f"{tr.group.tables[t].dim} wide": float(sl["beta1_power"])
              for t, sl in tr.ts.slots.items()}
    count = int(tr.ts.dense_opt["count"])
    if count != EPOCH_ADAM_POOL:
        raise AssertionError(f"phase {label}: dense Adam's count {count}")
    log(f"phase {label} Adam: beta1 powers after {EPOCH_ADAM_POOL} steps "
        f"{powers} (0.9 ** {EPOCH_ADAM_POOL + 1} = "
        f"{0.9 ** (EPOCH_ADAM_POOL + 1):.8f}), dense Adam's count {count}")
    tr.ts = start
    a_fetch, k3, _, _ = _compare_step_kernels(
        tr, "adam", f"{label} Adam first pool batch", pool[0])
    del tr, start, pool
    _release()

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_wdl_torch
    t0 = time.perf_counter()
    out = train_wdl_torch.main(TRAIN_WDL_ARGS)
    wall = time.perf_counter() - t0
    vals = [out["loss_first"], out["loss_last"], *out["loss_epoch_means"]]
    if not (all(np.isfinite(vals)) and 0.0 < out["auc"] < 1.0
            and out["backend"] == "cuda"):
        raise AssertionError(f"phase {label}: tools/train_wdl_torch.py "
                             f"{' '.join(TRAIN_WDL_ARGS)}: {out}")
    log(f"phase {label}: tools/train_wdl_torch.py "
        f"{' '.join(TRAIN_WDL_ARGS)} at full width: AUC {out['auc']}, "
        f"losses {vals}, {out['train_s_incl_compile']} s to train, "
        f"{wall:.3f} s in all")
    _release()
    records = (_path_records("epoch", launches, fetch, applies, gather_err,
                             apply_err, probes=probes, draws=draws)
               + _path_records("epoch", adam_launches, a_fetch, k3,
                               gather_err, apply_err, kind="adam")[1:])
    for rec in records:
        rec["graph_replays"] = (adam_replays if "adam" in rec["name"]
                                else replays)
    return records


def _record(name, source, replaces, launches, err, rec, path):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec.get("bound_by", "bytes"),
            "library_ms": rec.get("library_ms"), "path": path}


def _probe_record(path, launches, probes, kind="insert"):
    """P1 on one path: launches from its run, times and bound from its
    largest probe operands."""
    suffix = "" if path == "headline" else f"[{path}]"
    name = "hash_probe_" + ("find" if kind == "find" else "insert")
    top = max(probes, key=lambda r: r["bound_ms"])
    rec = _record(name + suffix, "deeprec_tpu_torch/csrc/hash_probe.cu",
                  "deeprec_tpu/embedding/hash_table.py:" + (
                      "256" if kind == "find" else "311"),
                  launches[name], 0.0, top, path)
    if kind != "find":
        rec.update(rounds=top["rounds"], plain_rounds=top["plain_rounds"])
    return rec


def _path_records(path, launches, fetch, applies, gather_err, apply_err,
                  kind="adagrad", probes=None, draws=None):
    """K1, P1 and P2 (where the path probes and draws) and the sparse
    apply of one training path: launches from its timed run, times and
    bound from its largest operands."""
    src = "deeprec_tpu_torch/csrc/"
    pallas = "deeprec_tpu/ops/pallas/"
    suffix = "" if path == "headline" else f"[{path}]"
    kname = f"{kind}_apply_rows"
    return ([_probe_record(path, launches, probes)] if probes else []) + (
        [_record("init_fresh_rows" + suffix, src + "init_rows.cu",
                 "deeprec_tpu/embedding/variable.py:446",
                 launches["init_fresh_rows"],
                 max(r["max_abs_err"] for r in draws),
                 max(draws, key=lambda r: r["bound_ms"]), path)]
        if draws else []) + [
        _record("gather_rows" + suffix, src + "gather_rows.cu",
                pallas + "gather.py:72", launches["gather_rows"],
                max([gather_err] + [r["max_abs_err"] for r in fetch]),
                max(fetch, key=lambda r: r["bound_ms"]), path),
        _record(kname + suffix, src + "sparse_apply.cu",
                pallas + ("sparse_apply.py:113" if kind == "adagrad"
                          else "sparse_apply.py:253"),
                launches[kname],
                max([apply_err] + [r["max_abs_err"] for r in applies]),
                max(applies, key=lambda r: r["bound_ms"]), path)]


def _zoo_counts(reset: bool = False) -> dict:
    """K1, K2, K3, P1 (insert, find) and P2 launch counts; zeroed first with
    ``reset``."""
    from deeprec_tpu_torch.ops.kernels import gather, hash_probe, init_rows
    from deeprec_tpu_torch.ops.kernels import sparse_apply as sa
    if reset:
        gather.launches = 0
        sa.launches["adagrad_apply_rows"] = 0
        sa.launches["adam_apply_rows"] = 0
        hash_probe.launches["find_or_insert"] = 0
        hash_probe.launches["find"] = 0
        init_rows.launches = 0
    return {"gather_rows": gather.launches,
            "adagrad_apply_rows": sa.launches["adagrad_apply_rows"],
            "hash_probe_insert": hash_probe.launches["find_or_insert"],
            "hash_probe_find": hash_probe.launches["find"],
            "init_fresh_rows": init_rows.launches,
            "adam_apply_rows": sa.launches["adam_apply_rows"]}


def _flat_outputs(out) -> list:
    """A model's output (logits, a task dict, DSSM's towers, DIEN's
    (logit, aux)) as a list of float32 tensors."""
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _flat_outputs(out[k])]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat_outputs(o)]
    return [out.detach().to(torch.float32)]


def _zoo_card_vs_cpu(tz, args, est, batch, rows: int) -> float:
    """The eval embeddings of ``batch``'s first ``rows`` rows from the
    card state, and the dense params, through the model on the card and
    through the same model built on the CPU; returns the largest
    absolute difference of the outputs."""
    from deeprec_tpu_torch.models.registry import ZOO
    from deeprec_tpu_torch.train import loop

    def cut(x):
        return tuple(cut(t) for t in x) if isinstance(x, tuple) else x[:rows]

    def cpu(x):
        return tuple(cpu(t) for t in x) if isinstance(x, tuple) else x.cpu()

    embs = {k: cut(v) for k, v in
            loop.eval_embeddings(est.group, est.ts, batch).items()}
    small = {k: v[:rows] for k, v in batch.items()
             if isinstance(v, torch.Tensor)}
    module = tz.make_module(args, est.group, "cpu")
    cpu_apply = ZOO[args.model].make_apply(module, est.group)
    with torch.no_grad():
        card = _flat_outputs(est.apply_fn(est.ts.params, embs, small))
        ref = _flat_outputs(cpu_apply(
            {k: v.cpu() for k, v in est.ts.params.items()},
            {k: cpu(v) for k, v in embs.items()},
            {k: v.cpu() for k, v in small.items()}))
    err = 0.0
    for a, b in zip(card, ref):
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{args.model}: card output {a.shape} vs CPU "
                                 f"{b.shape}, finite {torch.isfinite(a).all()}")
        err = max(err, float((a.cpu() - b).abs().max()))
    return err


def _zoo_resume(tz, args, est, argv, tmp: str, cpu_flag) -> str:
    """DIN across a save and a restore: the tool trained to
    ``ZOO_RESUME[0]`` steps then resumed to ``ZOO_RESUME[1]``; the
    in-process state saved by its manager and restored into a fresh
    estimator, key by key (the coalesced table holds the bag and the
    sequence columns of ``item_emb`` and ``cat_emb``)."""
    d = os.path.join(tmp, "din_tool")
    first, then = ZOO_RESUME
    runs = [tz.main(argv + ["--checkpoint", d, "--steps", str(n)] + cpu_flag)
            for n in (first, then)]
    if runs[1].get("resumed_from") != first or runs[1]["steps"] != then:
        raise AssertionError(f"din did not resume at {first}: {runs[1]}")
    t = time.perf_counter()
    est.manager.save(est.ts)
    save_s = time.perf_counter() - t
    est2, _, _, _ = tz.build(args, est.device)
    got = est2.restore_if_available()
    if got != est.ts.step:
        raise AssertionError(f"restored step {got}, not {est.ts.step}")
    live, back = _live_rows(est.group, est.ts.ev), _live_rows(est.group,
                                                             est2.ts.ev)
    for tname, want in live.items():
        for k, v in want.items():
            if not np.array_equal(back[tname][k], v):
                raise AssertionError(f"din restore {tname}: {k} differs")
    for k, v in est.ts.params.items():
        if not torch.equal(est2.ts.params[k], v):
            raise AssertionError(f"din restore: param {k} differs")
    n_keys = sum(len(v["keys"]) for v in live.values())
    del est2
    return (f"tool: {first} steps (loss {runs[0]['final_loss']}), resumed "
            f"from {runs[1]['resumed_from']} to {then} (loss "
            f"{runs[1]['final_loss']}); in process: step {est.ts.step} saved "
            f"in {save_s:.3f} s and restored into a fresh estimator, {n_keys} "
            f"keys of {', '.join(est.group.tables)} equal key by key (rows, "
            f"freqs, versions) and every dense param equal")


def phase_zoo(tmp: str, gather_err: float, apply_err: float, device="cuda"):
    """(o) the model zoo; see the module's docstring. Returns the kernels'
    records of the ``zoo/din`` and ``zoo/deepfm`` paths."""
    import types

    from deeprec_tpu_torch.train import loop as trainlib

    tz = _train_zoo()
    label = "21 (o)"
    dev = torch.device(device)
    cpu_flag = ["--cpu"] if dev.type == "cpu" else []
    records, summary = [], {}
    t_phase = time.perf_counter()
    for run in ZOO_RUNS:
        name, extra = run[0], list(run[1:])
        tag = name + ("_cat" if extra else "")
        argv = [name] + ZOO_ARGS + extra
        _zoo_counts(reset=True)                   # the main path starts here
        t0 = time.perf_counter()
        out = tz.main(argv + cpu_flag)
        launches = _zoo_counts()                  # the main path ends here
        tool_s = time.perf_counter() - t0
        _release()
        need = ("gather_rows", "adagrad_apply_rows", "hash_probe_insert",
                "init_fresh_rows")
        if min(launches[k] for k in need) < 1:
            raise AssertionError(f"phase {label} {tag}: a kernel of the path "
                                 f"did not launch: {launches}")
        if not np.isfinite(out["final_loss"]) or (
                "auc" in out and not 0.0 < out["auc"] < 1.0):
            raise AssertionError(f"phase {label} {tag}: {out}")

        # The same model in process: steps timed one by one, one step
        # with host syncs made errors, the forward against the CPU.
        args = tz.parse_args(argv + cpu_flag + (
            ["--checkpoint", os.path.join(tmp, "din_est")]
            if name == "din" else []))
        est, make_data, pack, _ = tz.build(args, dev)
        data = make_data(args.seed)
        warm, timed = ZOO_STEPS
        batches = [pack(data) for _ in range(warm + timed + 1)]
        kernels_here = name in ZOO_KERNEL_MODELS and not extra
        start = trainlib.clone_state(est.ts) if kernels_here else None
        ms, losses = [], []
        for b in batches[:warm + timed]:
            _sync(dev)
            t0 = time.perf_counter()
            est.ts, m = est._step_fn(est.ts, b)
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        if not all(np.isfinite(losses)):
            raise FloatingPointError(f"phase {label} {tag}: losses {losses}")
        step_ms = float(np.median(ms[warm:]))
        _sync(dev)
        with trainlib._no_host_sync():
            est.ts, m = est._step_fn(est.ts, batches[-1])
        _sync(dev)
        cpu_err = _zoo_card_vs_cpu(tz, args, est, batches[-1], ZOO_CPU_ROWS)
        if not cpu_err <= ZOO_CPU_ATOL:
            raise AssertionError(f"phase {label} {tag}: card vs CPU forward "
                                 f"max abs diff {cpu_err} > {ZOO_CPU_ATOL}")
        tables = ", ".join(f"{cfg.dim} x {cfg.capacity}"
                           for cfg in est.group.tables.values())
        summary[tag] = {"step_ms": round(step_ms, 3),
                        "samples_per_s": round(ZOO_BATCH / step_ms * 1e3, 1),
                        "loss": out["final_loss"], "auc": out.get("auc"),
                        "cpu_err": cpu_err}
        log(f"phase {label}: {tag} (tables {tables}): tools/train_zoo_torch.py "
            f"{' '.join(argv[1:])}: loss {out['final_loss']}"
            + (f", auc {out['auc']}" if "auc" in out else "")
            + f" in {tool_s:.3f} s; launches {launches}; in process median "
            f"synchronized step {step_ms:.3f} ms ({ZOO_BATCH / step_ms * 1e3:.1f}"
            f" samples/s) over {timed} steps after {warm} (losses "
            f"{[round(x, 5) for x in losses]}); one step under "
            f"set_sync_debug_mode('error'): no host sync; card vs CPU forward "
            f"on {ZOO_CPU_ROWS} rows: max abs diff {cpu_err:.3e}")
        if name == "din":
            log(f"phase {label}: din save and resume: "
                + _zoo_resume(tz, args, est, [name] + ZOO_ARGS, tmp,
                              cpu_flag))
        if kernels_here:
            # The operands of the run's first step: every row it touches
            # is fresh (P2 draws them all, P1 inserts every distinct id).
            tr = types.SimpleNamespace(
                ts=start, group=est.group, apply_fn=est.apply_fn,
                loss_fn=est.loss_fn, sparse_opt=est.sparse_opt)
            path = f"zoo/{name}"
            fetch, applies, probes, draws = _compare_step_kernels(
                tr, "adagrad", f"{label} {name} first step", batches[0])
            del tr, start
            with captured_probes() as evals:
                est.predict(pack(make_data(args.seed + 10_001)))
            finds = compare_probes(f"{label} {name} eval", evals)
            records += (_path_records(path, launches, fetch, applies,
                                      gather_err, apply_err, probes=probes,
                                      draws=draws)
                        + [_probe_record(path, launches, finds, kind="find")])
        del est, batches
        _release()
    log(f"phase {label}: {len(ZOO_RUNS)} runs in "
        f"{time.perf_counter() - t_phase:.3f} s; summary {json.dumps(summary)}")
    return records


def phase_zoo_epoch(device="cuda") -> dict:
    """(p) the zoo's captured epochs; see the module's docstring.
    Returns the launches of the captured calls summed over the runs."""
    import types

    tz = _train_zoo()
    label = "22 (p)"
    summary, total = {}, {}
    t_phase = time.perf_counter()
    for run in ZOO_RUNS:
        name, extra = run[0], list(run[1:])
        tag = name + ("_cat" if extra else "")
        args = tz.parse_args([name] + ZOO_ARGS + extra)
        est, make_data, pack, _ = tz.build(args, torch.device(device))
        data = make_data(args.seed)
        pool = [pack(data) for _ in range(ZOO_EPOCH_POOL)]
        tr = types.SimpleNamespace(
            ts=est.ts, step=est._step_fn, group=est.group,
            apply_fn=est.apply_fn, loss_fn=est.loss_fn,
            sparse_opt=est.sparse_opt, dense_opt=est.dense_opt)
        _, launches, stats = eager_vs_graph(tr, pool, ZOO_EPOCH_EPOCHS,
                                            "adagrad", f"{label} {tag}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        summary[tag] = {"replay_ms": round(stats["replay_ms"], 3),
                        "eager_ms": round(stats["eager_ms"], 3)}
        del est, tr, pool
        _release()
    log(f"phase {label}: {len(ZOO_RUNS)} zoo runs captured, each bit-equal "
        f"to its eager loop, in {time.perf_counter() - t_phase:.3f} s; "
        f"device ms a replayed step and eager median ms: "
        f"{json.dumps(summary)}; launches summed {total}")
    return total


def _tool(name):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    return __import__(name)


def phase_tools(tmp: str) -> list:
    """(p) each measuring tool once at its smallest useful size, in this
    process; see the module's docstring. Returns the kernels' records of
    the kernel benchmark's jobs."""
    label = "22 (p) tools"
    t_all = time.perf_counter()
    za, zd = _tool("zoo_auc_torch"), _tool("zoo_delta_torch")
    docs = {}
    for fp32 in (False, True):
        row = za.run("din", TOOL_AUC_STEPS, bf16=not fp32,
                     pool=TOOL_AUC_POOL, lr=0.3, items=20_000)
        res = row["memory_reserved_mib"]
        if not (ZOO_AUC_ROW_KEYS <= set(row) and 0.0 < row["auc"] < 1.0
                and np.isfinite(row["loss_epoch_means"]).all()
                and max(res[1:]) <= res[1]):
            raise AssertionError(f"phase {label}: zoo_auc_torch din: {row}")
        docs[fp32] = os.path.join(tmp, f"zoo_auc_{int(fp32)}.json")
        with open(docs[fp32], "w") as f:
            json.dump({"models": [row]}, f)
        log(f"phase {label}: zoo_auc_torch din {row['steps']} steps "
            f"({row['mode']}, pool {TOOL_AUC_POOL}): AUC {row['auc']}, loss "
            f"means {row['loss_epoch_means']}, {row['replay_ms_per_step']} "
            f"ms a replayed step, reserved MiB after each epoch {res}")
    zd.main(["--main", docs[False], "--fp32", docs[True]])
    with open(docs[False]) as f:
        merged = json.load(f)["models"][0]
    if "bf16_fp32_delta" not in merged:
        raise AssertionError(f"phase {label}: zoo_delta_torch: {merged}")

    mb, wbz = _tool("model_benchmark_torch"), _tool("write_bench_zoo_torch")
    row = mb.bench_model("deepfm", warmup=TOOL_BENCH_STEPS[0],
                         measure=TOOL_BENCH_STEPS[1])
    jsonl = os.path.join(tmp, "bench.jsonl")
    with open(jsonl, "w") as f:
        f.write(json.dumps(row) + "\n")
    wbz.main([jsonl, "--out", os.path.join(tmp, "bench.json")])
    if not (row["value"] > 0 and row["flops_per_step"] > 0
            and ("mfu" not in row or 0 < row["mfu"] < 1)
            and np.isfinite(row["loss"])):
        raise AssertionError(f"phase {label}: model_benchmark_torch: {row}")
    log(f"phase {label}: model_benchmark_torch deepfm (warm-up "
        f"{TOOL_BENCH_STEPS[0]}, {TOOL_BENCH_STEPS[1]} measured): "
        f"{json.dumps(row)}")

    rows = _tool("serving_benchmark_torch").bench_device(
        TOOL_SERVING_BATCHES, requests=TOOL_SERVING_REQUESTS)
    log(f"phase {label}: serving_benchmark_torch: {json.dumps(rows)}")

    sbd = _tool("step_breakdown_torch")
    out = sbd.breakdown(sbd.parse_args(TOOL_BREAKDOWN_ARGS),
                        torch.device("cuda"))
    if not 0.5 < out["phase_sum_over_full"] < 2.0:
        raise AssertionError(f"phase {label}: step_breakdown_torch: {out}")
    log(f"phase {label}: step_breakdown_torch {' '.join(TOOL_BREAKDOWN_ARGS)}"
        f": phases {out['phases_ms']}, sum over full "
        f"{out['phase_sum_over_full']}")

    kb = _tool("kernel_benchmark_torch")
    src = "deeprec_tpu_torch/csrc/"
    pallas = "deeprec_tpu/ops/pallas/"
    origin = {
        "gather_rows": (src + "gather_rows.cu", pallas + "gather.py:72"),
        "adagrad_apply_rows": (src + "sparse_apply.cu",
                               pallas + "sparse_apply.py:113"),
        "adam_apply_rows": (src + "sparse_apply.cu",
                            pallas + "sparse_apply.py:253"),
        "hash_probe_insert": (src + "hash_probe.cu",
                              "deeprec_tpu/embedding/hash_table.py:311"),
        "hash_probe_find": (src + "hash_probe.cu",
                            "deeprec_tpu/embedding/hash_table.py:256")}
    records = []
    for job in kb.JOBS:
        _zoo_counts(reset=True)             # the job's path starts here
        lines = kb.run_job(*job)
        launches = _zoo_counts()            # and ends here
        for ln in lines:
            path = f"kernel_benchmark/{job[0]}"
            records.append(_record(
                f"{ln['kernel']}[{path}]", *origin[ln["kernel"]],
                launches[ln["kernel"]], ln["max_abs_err"], ln, path))
    env = _tool("env_collect_torch").collect(True)
    log(f"phase {label}: env_collect_torch: torch {env['torch']} (CUDA "
        f"{env['torch_cuda']}), {env['nvcc']}, driver {env['driver']}, "
        f"cards {env['cards']}; the tools took "
        f"{time.perf_counter() - t_all:.3f} s")
    return records


def _zoo_epoch_records(launches, zoo_records) -> list:
    """K1, K2, P1 and P2 on the zoo's captured path: launches summed over
    phase 22's captured calls; times, bound and errors from phase 21's
    DIN first step, which the captured DIN epoch's first step repeats
    (the same seed, batches, weights and fresh tables)."""
    out = []
    for rec in zoo_records:
        if rec["path"] != "zoo/din" or rec["name"].startswith(
                "hash_probe_find"):
            continue
        base = rec["name"].split("[")[0]
        out.append(dict(rec, name=f"{base}[zoo_epoch]", path="zoo_epoch",
                        launches=launches[base], times_from="zoo/din"))
    return out


def _table_keys_rows(cfg, state, owner=None):
    """(sorted int64 keys, their rows) of a table's live rows; with
    ``owner = (rank, S)``, only the keys the shard hash gives that rank."""
    from deeprec_tpu_torch.embedding import variable as ev
    from deeprec_tpu_torch.utils import keys as keylib
    snap = ev.export_arrays(cfg, state)
    keys, rows = snap["keys"], snap["values"]
    if owner is not None:
        mine = keylib.shard_of_np(keys, owner[1]) == owner[0]
        keys, rows = keys[mine], rows[mine]
    order = np.argsort(keys)
    return keys[order], rows[order]


def _trace_summary(trace) -> dict:
    """Per collective kind of a traced step: calls, bytes this rank sent
    and the ms between each call's CUDA events, summed."""
    out = {}
    for rec in trace:
        start, end = rec["events"]
        end.synchronize()
        d = out.setdefault(rec["kind"], {"calls": 0, "bytes": 0, "ms": []})
        d["calls"] += 1
        d["bytes"] += rec["bytes"]
        d["ms"].append(start.elapsed_time(end))
    return out


def _collectives_check(mesh, label: str):
    """The mesh's backend on CUDA tensors: ``all_to_all_single``,
    ``all_gather`` and ``all_reduce`` give the right results (gloo
    stages CUDA tensors through host memory, where its build allows)."""
    S, r, dev = mesh.size, mesh.rank, mesh.device
    x = torch.arange(4 * S, dtype=torch.int32, device=dev) + 100 * r
    peers = [torch.arange(4, dtype=torch.int32) + 100 * j for j in range(S)]
    want = {"all_to_all": torch.cat([p + 4 * r for p in peers]),
            "all_gather": torch.cat(peers),
            "all_reduce": torch.arange(4 * S, dtype=torch.int32) * S
            + 100 * sum(range(S))}
    got = {"all_to_all": mesh.all_to_all(x),
           "all_gather": mesh.all_gather(x[:4]),
           "all_reduce": mesh.all_reduce_(x.clone())}
    for k, v in got.items():
        if not torch.equal(v.cpu(), want[k]):
            raise AssertionError(f"phase {label}: {mesh.backend} {k} on "
                                 f"CUDA tensors gave {v.tolist()}")
    log(f"phase {label}: {mesh.backend} takes CUDA tensors in "
        f"all_to_all_single, all_gather and all_reduce (results right)")


def _sharded_run(mesh, tmp: str, compare_kernels: bool) -> dict:
    """Phase 23 on one rank: the headline WDL sharded over ``mesh`` and
    the unsharded headline on the same global batches, both on this
    rank's card; see :func:`phase_sharded`."""
    from deeprec_tpu_torch import bench
    from deeprec_tpu_torch.train import checkpoint as ckptlib
    from deeprec_tpu_torch.train import loop as trainlib
    dev, S, r = mesh.device, mesh.size, mesh.rank
    part = "a" if mesh.backend == "nccl" else "b"
    label = f"23 ({part}) rank {r} of {S}, {mesh.backend}"
    group_kw = ({} if part == "a" else dict(
        placement="auto", replicate_threshold=GLOO_REPLICATE_THRESHOLD))
    _collectives_check(mesh, label)
    tr = bench.build_wdl(device=dev, mesh=mesh, group_kw=group_kw)
    ref = bench.build_wdl(device=dev, batch=BATCH * S)
    plan = tr.group.placement_plan()
    log(f"phase {label}: placement {plan}; this rank's tables "
        f"{_table_shapes(tr)}, B = {BATCH} a rank")
    batches = [tr.next_batch() for _ in range(SHARDED_STEPS + 2)]
    ref_batches = [ref.next_batch() for _ in range(SHARDED_STEPS + 1)]

    count_syncs = _tool("profile_train_torch").count_syncs

    def run(trainer, bs, traced: bool):
        ts, losses, over, ms, syncs, trace = trainer.ts, [], [], [], {}, {}
        for i, b in enumerate(bs):
            if traced and i == SHARDED_STEPS - 2:
                mesh.trace = []
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            box = {}

            def step(ts_, b_):
                box["ts"], box["m"] = trainer.step(ts_, b_)
                return box["ts"], box["m"]

            events[0].record()
            if i == SHARDED_STEPS - 1:
                syncs = count_syncs(step, ts, b)[1]
            else:
                step(ts, b)
            events[1].record()
            ts, m = box["ts"], box["m"]
            events[1].synchronize()
            ms.append(events[0].elapsed_time(events[1]))
            losses.append(float(m["loss"]))
            over.append(int(m["n_overflow"]))
            if traced and mesh.trace is not None:
                trace = _trace_summary(mesh.trace)
                mesh.trace = None
        trainer.ts = ts
        return losses, over, ms, syncs, trace

    _zoo_counts(reset=True)
    losses, over, ms, syncs, trace = run(tr, batches[:SHARDED_STEPS], True)
    launches = _zoo_counts()
    ref_losses, _, ref_ms, ref_syncs, _ = run(
        ref, ref_batches[:SHARDED_STEPS], False)
    if any(over):
        raise AssertionError(f"phase {label}: n_overflow {over}")
    if syncs or ref_syncs:
        raise AssertionError(f"phase {label}: host syncs in a step: sharded "
                             f"{syncs}, unsharded {ref_syncs}")
    if not all(np.isfinite(losses)):
        raise FloatingPointError(f"phase {label}: losses {losses}")
    np.testing.assert_allclose(losses, ref_losses, rtol=SHARDED_LOSS_RTOL,
                               err_msg=f"phase {label}: loss")
    missing = [k for k in ("gather_rows", "adagrad_apply_rows",
                           "hash_probe_insert", "init_fresh_rows")
               if launches[k] < 1]
    if missing:
        raise AssertionError(f"phase {label}: no launch of {missing} on the "
                             f"sharded path ({launches})")
    row_err = {}
    for t, cfg in tr.group.tables.items():
        owner = (r, S) if tr.group._is_stacked(t) else None
        k_m, v_m = _table_keys_rows(cfg, tr.ts.ev[t])
        k_r, v_r = _table_keys_rows(ref.group.tables[t], ref.ts.ev[t],
                                    owner)
        if not np.array_equal(k_m, k_r):
            raise AssertionError(f"phase {label}: table {t}: key sets "
                                 f"differ ({k_m.size} keys against "
                                 f"{k_r.size})")
        np.testing.assert_allclose(v_m, v_r, **SHARDED_ROW_TOL,
                                   err_msg=f"phase {label}: rows of {t}")
        row_err[t] = float(np.abs(v_m - v_r).max()) if v_m.size else 0.0
    rows = slice(r * BATCH, (r + 1) * BATCH)
    logits = trainlib.make_eval_step(tr.group, tr.apply_fn, mesh)(
        tr.ts, batches[SHARDED_STEPS]).float()
    ref_eval = trainlib.make_eval_step(ref.group, ref.apply_fn)
    ref_logits = ref_eval(ref.ts, ref_batches[SHARDED_STEPS]).float()[rows]
    eval_err = float((logits - ref_logits).abs().max())
    if not eval_err <= SHARDED_LOGIT_ATOL:
        raise AssertionError(f"phase {label}: sharded eval logits differ "
                             f"from the unsharded ones by {eval_err}")
    ckpt = os.path.join(tmp, f"ckpt-{mesh.backend}")
    t0 = time.perf_counter()
    ckptlib.CheckpointManager(ckpt, tr.group, mesh=mesh).save(tr.ts)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = ckptlib.CheckpointManager(ckpt, ref.group).restore(ref.ts)
    restore_s = time.perf_counter() - t0
    for t, cfg in tr.group.tables.items():
        owner = (r, S) if tr.group._is_stacked(t) else None
        k_m, v_m = _table_keys_rows(cfg, tr.ts.ev[t])
        k_r, v_r = _table_keys_rows(ref.group.tables[t], restored.ev[t],
                                    owner)
        if not (np.array_equal(k_m, k_r) and np.array_equal(v_m, v_r)):
            raise AssertionError(f"phase {label}: table {t} restored "
                                 f"unsharded differs from the shard saved")
    restored_logits = ref_eval(restored, ref_batches[SHARDED_STEPS]).float()
    restore_err = float((restored_logits[rows] - logits).abs().max())
    if not restore_err <= SHARDED_LOGIT_ATOL:
        raise AssertionError(f"phase {label}: eval logits of the unsharded "
                             f"restore differ by {restore_err}")
    del restored, ref
    torch.cuda.empty_cache()
    out = {"placement": plan, "losses": losses, "ref_losses": ref_losses,
           "n_overflow": over, "step_ms": ms, "ref_step_ms": ref_ms,
           "syncs": syncs, "ref_syncs": ref_syncs, "trace": trace,
           "launches": launches, "row_err": row_err, "eval_err": eval_err,
           "restore_err": restore_err, "save_s": save_s,
           "restore_s": restore_s}
    if compare_kernels:
        fetch, applies, probes, draws = _compare_step_kernels(
            tr, "adagrad", f"{label} owner side", batches[SHARDED_STEPS + 1])
        out["kernels"] = {"fetch": fetch, "applies": applies,
                          "probes": probes, "draws": draws}
    return out


def _sharded_rank(rank, world, backend, tmp, card, draws, compare_kernels):
    """A spawned rank of phase 23: joins a ``backend`` group of ``world``
    ranks (a ``FileStore`` under ``tmp``), runs :func:`_sharded_run` and
    writes its results to ``tmp/<backend>-r<rank>.json``."""
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from deeprec_tpu_torch.parallel import mesh as meshlib
    from deeprec_tpu_torch.parallel import multihost
    CARD.update(card)
    DRAW_INSTRUCTIONS.update(draws)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(
        backend=backend, rank=rank, world_size=world, device="cuda",
        init_method="file://" + os.path.join(tmp, f"store-{backend}"))
    try:
        out = _sharded_run(meshlib.data_mesh(world), tmp, compare_kernels)
        with open(os.path.join(tmp, f"{backend}-r{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def phase_sharded(tmp: str):
    """Phase 23: the sharded path in spawned ranks (a rank that raises
    fails the spawn). Returns (summed launches, rank 0's kernel records
    of (a))."""
    import torch.multiprocessing as mp
    results = {}
    for part, backend, world in (("a", "nccl", torch.cuda.device_count()),
                                 ("b", "gloo", 2)):
        t0 = time.perf_counter()
        mp.spawn(_sharded_rank, nprocs=world, join=True, args=(
            world, backend, tmp, dict(CARD), dict(DRAW_INSTRUCTIONS),
            part == "a"))
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"{backend}-r{r}.json")) as f:
                ranks.append(json.load(f))
        results[part] = ranks
        for r, res in enumerate(ranks):
            tr_ = res["trace"]
            xbytes = sum(d["bytes"] for d in tr_.values())
            log(f"phase 23 ({part}) {backend} rank {r} of {world}: "
                f"placement {res['placement']}; losses {res['losses']} "
                f"(unsharded {res['ref_losses']}, rtol "
                f"{SHARDED_LOSS_RTOL}); n_overflow {res['n_overflow']}; "
                f"rows' max abs diff from the unsharded tables "
                f"{res['row_err']}; eval logits {res['eval_err']:.3g}, "
                f"after an unsharded restore {res['restore_err']:.3g}; "
                f"save {res['save_s']:.3f} s, unsharded restore "
                f"{res['restore_s']:.3f} s; launches {res['launches']}")
            log(f"phase 23 ({part}) rank {r}: ms a step between CUDA "
                f"events: sharded {res['step_ms']} (median of steps 2-"
                f"{SHARDED_STEPS - 1} {np.median(res['step_ms'][1:-1]):.3f}"
                f"), unsharded {res['ref_step_ms']} (median "
                f"{np.median(res['ref_step_ms'][1:-1]):.3f}); host syncs in "
                f"step {SHARDED_STEPS}: sharded {sum(res['syncs'].values())}"
                f" {res['syncs']}, unsharded "
                f"{sum(res['ref_syncs'].values())}; exchanged in step "
                f"{SHARDED_STEPS - 1}: {xbytes} bytes sent by this rank; "
                + "; ".join(
                    f"{k}: {d['calls']} calls, {d['bytes']} bytes, ms "
                    f"{[round(x, 4) for x in d['ms']]} (sum "
                    f"{sum(d['ms']):.4f})" for k, d in tr_.items()))
        log(f"phase 23 ({part}): {world} {backend} rank(s) in "
            f"{time.perf_counter() - t0:.3f} s")
    launches = {}
    for res in results["a"]:
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches, results["a"][0]["kernels"]


# -- phase 24 (r): table variants ---------------------------------------------

@contextlib.contextmanager
def counting_newly_hot():
    """Record, per call of ``EmbeddingGroup.migrate_adaptive`` (one a
    training step), the ids that went hot: a device tensor each, read
    after the run (no host sync in the step)."""
    from deeprec_tpu_torch.feature_column.feature_column import (
        EmbeddingGroup)
    counts = []
    orig = EmbeddingGroup.migrate_adaptive

    def counting(self, states, gl, params):
        seen = {}
        for cl in gl.columns.values():
            if cl.adp is not None:
                seen.setdefault(cl.table_name, cl.adp.newly_hot)
        if seen:
            counts.append(sum(m.sum() for m in seen.values()))
        return orig(self, states, gl, params)

    EmbeddingGroup.migrate_adaptive = counting
    try:
        yield counts
    finally:
        EmbeddingGroup.migrate_adaptive = orig


def _variant_columns(tz, kind: str):
    """The zoo WDL's columns (``tz.COLUMN_KWARGS["wdl"]``) for a phase
    24 variant: "adaptive" (threshold 3, 2**14 buckets, as the tool's
    flags), "dyn_dim" (each deep column in 4 blocks unlocking at
    ``VARIANT_THRESHOLDS``, masked) or "dyn_dim_hot" (the same with a
    hot sibling of capacity / ``VARIANT_HOT_SHARE``)."""
    import dataclasses
    args = tz.parse_args(VARIANT_TOOL_ARGS if kind == "adaptive"
                         else VARIANT_TOOL_ARGS[:1] + VARIANT_TOOL_ARGS[2:])
    cols = tz.columns(args)
    if kind == "adaptive":
        return cols
    out = []
    for c in cols:
        if hasattr(c, "dim") and not c.name.endswith("_wide"):
            c = dataclasses.replace(
                c, dyn_dim_blocks=4, dyn_dim_thresholds=VARIANT_THRESHOLDS,
                dyn_dim_hot_capacity=(c.capacity // VARIANT_HOT_SHARE
                                      if kind == "dyn_dim_hot" else None))
        out.append(c)
    return out


def _variant_trainer(tz, kind: str, dev, sparse_opt=None, mesh=None):
    """A phase 24 model (:func:`_variant_columns`) built as
    ``tz.build`` builds the zoo's WDL (seeded towers, dense Adam, the
    adaptive static tables among the params), with ``sparse_opt`` (default
    ``SparseAdagrad`` at the tool's rate); on a ``mesh`` its tables
    sharded and each rank fed its rows of the global batch."""
    import types

    from deeprec_tpu_torch.data.criteo import CRITEO_HASH_BUCKETS
    from deeprec_tpu_torch.feature_column.feature_column import (
        EmbeddingGroup)
    from deeprec_tpu_torch.layers.core import init_dense
    from deeprec_tpu_torch.models.registry import ZOO
    from deeprec_tpu_torch.optimizers import dense as dense_lib
    from deeprec_tpu_torch.optimizers import sparse as sparse_lib
    from deeprec_tpu_torch.train import loop
    args = tz.parse_args(VARIANT_TOOL_ARGS)
    S, r = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    group = EmbeddingGroup(
        _variant_columns(tz, kind), coalesce=True,
        **({} if mesh is None else dict(axis_name="data", num_shards=S)))
    module = tz.make_module(args, group, dev)
    init_dense(module, torch.Generator().manual_seed(args.seed))
    params = {**module.state_dict(),
              **group.adaptive_static_params(dev, args.seed)}
    sopt = sparse_opt or sparse_lib.SparseAdagrad(args.learning_rate)
    dopt = dense_lib.Adam(2e-3)
    entry = ZOO["wdl"]
    apply_fn = entry.make_apply(module, group)
    ts = loop.create_train_state(group, params, dopt, sopt, dev, mesh)
    step = loop.make_train_step(group, apply_fn, entry.loss, sopt, dopt,
                                mesh=mesh)
    data = entry.make_data(batch_size=ZOO_BATCH * S,
                           vocab=CRITEO_HASH_BUCKETS, seed=args.seed)
    wide = any(c.name.endswith("_wide") for c in group.embedding)

    def next_batch():
        raw = data.next_batch_np(wide=wide)
        raw = {k: np.asarray(v)[r * ZOO_BATCH:(r + 1) * ZOO_BATCH]
               for k, v in raw.items()}
        return group.pack_batch_np(raw, dev)

    return types.SimpleNamespace(
        ts=ts, step=step, group=group, apply_fn=apply_fn,
        loss_fn=entry.loss, sparse_opt=sopt, dense_opt=dopt,
        next_batch=next_batch, mesh=mesh)


def _timed_steps(tr, label: str, dev):
    """``VARIANT_STEPS`` steps (warm-up, timed) of ``tr``, each
    synchronized; then one more under ``set_sync_debug_mode("error")``
    (CUDA). Returns (median ms, losses)."""
    from deeprec_tpu_torch.train import loop
    warm, timed = VARIANT_STEPS
    ms, losses = [], []
    for _ in range(warm + timed):
        b = tr.next_batch()
        _sync(dev)
        t0 = time.perf_counter()
        tr.ts, m = tr.step(tr.ts, b)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    b = tr.next_batch()
    _sync(dev)
    ctx = loop._no_host_sync() if dev.type == "cuda" else \
        contextlib.nullcontext()
    with ctx:
        tr.ts, m = tr.step(tr.ts, b)
    losses.append(float(m["loss"]))
    if not all(np.isfinite(losses)):
        raise FloatingPointError(f"phase {label}: losses {losses}")
    return float(np.median(ms[warm:])), losses


def _unlocked_shares(group, states) -> dict:
    """Per dyn-dim base table, the share of its live keys at or past each
    unlock threshold (their freq counters)."""
    from deeprec_tpu_torch.embedding import hash_table as ht
    out = {}
    for t, cfg in group.tables.items():
        thr = VARIANT_THRESHOLDS
        if t.endswith("#hot") or not (cfg.block_num > 1 or t in
                                      group._dyn_hot):
            continue
        live = ht.live_mask(states[t].table)
        f = states[t].freqs[:-1][live]
        n = max(int(live.sum()), 1)
        out[t] = [round(int((f >= x).sum()) / n, 4) for x in thr]
    return out


def _variant_adaptive(tmp: str, dev, gather_err, apply_err, label):
    """(a) and (b) of phase 24; returns (records, step ms, epoch stats)."""
    import types

    from deeprec_tpu_torch.serving.processor import ServingModel
    from deeprec_tpu_torch.train import checkpoint as ckptlib
    from deeprec_tpu_torch.train import loop
    tz = _train_zoo()
    d = os.path.join(tmp, "adaptive")
    argv = VARIANT_TOOL_ARGS + ["--checkpoint", d] + (
        ["--cpu"] if dev.type == "cpu" else [])
    built, build = [], tz.build

    def keep(*a, **k):
        built.append(build(*a, **k))
        return built[-1]

    tz.build = keep
    try:
        _zoo_counts(reset=True)                  # the main path starts here
        with counting_newly_hot() as newly:
            t0 = time.perf_counter()
            out = tz.main(argv)
            tool_s = time.perf_counter() - t0
        launches = _zoo_counts()                 # the main path ends here
    finally:
        tz.build = build
    est, make_data, pack, _ = built[0]
    newly = [int(x) for x in newly]
    need = ("gather_rows", "adagrad_apply_rows", "hash_probe_insert",
            "init_fresh_rows", "hash_probe_find")
    if min(launches[k] for k in need) < 1:
        raise AssertionError(f"phase {label}: a kernel of the adaptive path "
                             f"did not launch: {launches}")
    if not (np.isfinite(out["final_loss"]) and 0.0 < out["auc"] < 1.0):
        raise AssertionError(f"phase {label}: {out}")
    if sum(newly) < 1:
        raise AssertionError(f"phase {label}: no id went hot: {newly}")
    group = est.group
    log(f"phase {label} (a): tools/train_zoo_torch.py "
        f"{' '.join(VARIANT_TOOL_ARGS[1:])}: {len(group.tables)} adaptive "
        f"tables, static tables of {group.tables['C1'].adaptive_buckets} "
        f"buckets; loss {out['final_loss']}, auc {out['auc']} in "
        f"{tool_s:.3f} s; newly hot ids a step {newly}; launches {launches}")

    # The end-of-run save restored and served.
    restored = ckptlib.CheckpointManager(d, group).restore(est.ts)
    served = ServingModel(group, est.apply_fn, est.ts, d)
    version = served.full_update()
    eval_step = loop.make_eval_step(group, est.apply_fn)
    requests = make_data(10_001)
    diffs = []
    for _ in range(3):
        b = pack(requests, dev)
        got, want = served.predict(b), eval_step(restored, b)
        live = eval_step(est.ts, b)
        if not (torch.equal(got, want) and torch.equal(want, live)):
            raise AssertionError(f"phase {label}: served logits differ from "
                                 f"the eval step's on the restored state")
        if not bool(torch.isfinite(got).all()):
            raise FloatingPointError(f"phase {label}: served {got}")
        diffs.append(float(got.float().std()))
    log(f"phase {label} (a): the step-{version} save restored; "
        f"ServingModel's logits on 3 requests of {ZOO_BATCH} rows equal "
        f"make_eval_step's on the restored state and on the live one, "
        f"bit for bit (logit std {[round(x, 4) for x in diffs]})")
    del restored, served

    # In process: timed steps, then each kernel on a step's operands.
    tr = types.SimpleNamespace(
        ts=est.ts, step=est._step_fn, group=group, apply_fn=est.apply_fn,
        loss_fn=est.loss_fn, sparse_opt=est.sparse_opt,
        dense_opt=est.dense_opt,
        next_batch=lambda data=make_data(1): pack(data, dev))
    step_ms, losses = _timed_steps(tr, label + " (a)", dev)
    with counting_newly_hot() as newly:
        fetch, applies, probes, draws = _compare_step_kernels(
            tr, "adagrad", f"{label} (a) adaptive step", tr.next_batch(),
            limit=VARIANT_LIMIT)
    with captured_probes() as evals:
        est.predict(tr.next_batch())
    finds = compare_probes(f"{label} (a) eval",
                           _largest(evals, VARIANT_LIMIT,
                                    lambda a: a[2].numel()))
    log(f"phase {label} (a): median synchronized step {step_ms:.3f} ms "
        f"({ZOO_BATCH / step_ms * 1e3:.1f} samples/s) over "
        f"{VARIANT_STEPS[1]} steps after {VARIANT_STEPS[0]} (losses "
        f"{[round(x, 5) for x in losses]}); one step under "
        f"set_sync_debug_mode('error'); the compared step's newly hot ids "
        f"{[int(x) for x in newly]} (their rows seeded, K2 updating from "
        f"the lookup's rows)")
    path = "table_variants/adaptive"
    records = (_path_records(path, launches, fetch, applies, gather_err,
                             apply_err, probes=probes, draws=draws)
               + [_probe_record(path, launches, finds, kind="find")])

    # (b) the same model captured, against its eager loop.
    pool = [tr.next_batch() for _ in range(VARIANT_POOL)]
    if dev.type == "cuda":
        _, e_launches, stats = eager_vs_graph(tr, pool, 1, "adagrad",
                                              f"{label} (b)")
        for rec in records[:-1]:
            base = rec["name"].split("[")[0]
            records.append(dict(rec, name=f"{base}[{path}_epoch]",
                                path=path + "_epoch",
                                launches=e_launches[base], times_from=path,
                                graph_replays=stats["replays"]))
    else:
        stats = {}
    del est, tr, pool, built
    _release()
    return records, step_ms, stats


def _variant_dyn_dim(kind: str, sparse: str, dev, gather_err, apply_err,
                     label):
    """(c) and (d) of phase 24: one dyn-dim model, ``sparse`` "adagrad"
    (K2) or "adam" (K3). Returns (records, step ms)."""
    from deeprec_tpu_torch.embedding import dyn_dim as ddlib
    from deeprec_tpu_torch.embedding import hash_table as ht
    from deeprec_tpu_torch.optimizers import sparse as sparse_lib
    tz = _train_zoo()
    tr = _variant_trainer(
        tz, kind, dev,
        sparse_lib.SparseAdam() if sparse == "adam" else None)
    group = tr.group
    _zoo_counts(reset=True)                      # the main path starts here
    step_ms, losses = _timed_steps(tr, label, dev)
    launches = _zoo_counts()                     # the main path ends here
    kname = f"{sparse}_apply_rows"
    need = ("gather_rows", kname, "hash_probe_insert", "init_fresh_rows")
    if min(launches[k] for k in need) < 1:
        raise AssertionError(f"phase {label}: a kernel of the {kind} path "
                             f"did not launch: {launches}")
    shares = _unlocked_shares(group, tr.ts.ev)
    if not any(v[-1] > 0 for v in shares.values()):
        raise AssertionError(f"phase {label}: no key unlocked every block: "
                             f"{shares}")
    memory = ""
    if kind == "dyn_dim_hot":
        full = stored = 0
        for c in group.embedding:
            tc = c.table_config()
            if tc.block_num > 1:
                full += tc.capacity * tc.dim
                stored += ddlib.DynDimEV(
                    tc, c.dyn_dim_hot_capacity).memory_rows()
        hot = list(group._dyn_hot.values())
        live_hot = sum(int(ht.num_live(tr.ts.ev[t].table)) for t in hot)
        memory = (f"; memory_rows {stored} floats against capacity * dim "
                  f"{full} (ratio {stored / full:.4f}); hot sibling "
                  f"capacities {sorted({group.tables[t].capacity for t in hot})}"
                  f", {live_hot} live hot rows")
    tables = sorted({(cfg.dim, cfg.capacity, cfg.block_num)
                     for cfg in group.tables.values()})
    log(f"phase {label}: {kind}, {sparse}: {len(group.tables)} tables "
        f"(dim, capacity, block_num) {tables}; median synchronized step "
        f"{step_ms:.3f} ms ({ZOO_BATCH / step_ms * 1e3:.1f} samples/s) over "
        f"{VARIANT_STEPS[1]} steps after {VARIANT_STEPS[0]}, losses "
        f"{[round(x, 5) for x in losses]}, one step under "
        f"set_sync_debug_mode('error'); share of live keys at or past "
        f"thresholds {VARIANT_THRESHOLDS}: {shares}{memory}; launches "
        f"{launches}")
    fetch, applies, probes, draws = _compare_step_kernels(
        tr, sparse, f"{label} {kind} {sparse} step", tr.next_batch(),
        limit=VARIANT_LIMIT)
    del tr
    _release()
    path = "table_variants/" + kind + ("_adam" if sparse == "adam" else "")
    recs = _path_records(path, launches, fetch, applies, gather_err,
                         apply_err, kind=sparse, probes=probes, draws=draws)
    return recs, step_ms


def _variant_tensible(dev, label):
    """(e) of phase 24: a TensibleEV grown once on the card. Returns P1's
    records (the growth's re-inserts, the regrown table's find)."""
    from deeprec_tpu_torch import config as cfglib
    from deeprec_tpu_torch.embedding import hash_table as ht
    from deeprec_tpu_torch.embedding import lookup as lkup
    from deeprec_tpu_torch.embedding import tensible
    from deeprec_tpu_torch.embedding import variable as ev
    from deeprec_tpu_torch.optimizers import sparse as sparse_lib
    from deeprec_tpu_torch.utils import keys as keylib
    cfg = cfglib.TableConfig(name="tensible", dim=TENSIBLE_DIM,
                             capacity=TENSIBLE_CAPACITY, init_scale=0.1)
    t = tensible.TensibleEV(cfg, sparse_lib.SparseAdagrad(0.05),
                            growth_threshold=0.5, device=dev)
    rng = np.random.default_rng(5)
    _zoo_counts(reset=True)                      # the main path starts here
    step, grew = 0, False
    while not grew:
        ids = rng.integers(0, 1 << 40, TENSIBLE_BATCH, dtype=np.int64)
        hi, lo = keylib.split_ids(ids)
        dd = lkup.dedup(torch.from_numpy(hi).to(dev),
                        torch.from_numpy(lo).to(dev))
        lk = t.lookup_train(dd.uhi, dd.ulo, dd.counts, step)
        g = torch.randn(lk.rows.shape, device=dev) * 0.1
        t.apply_gradients(lk, g, step)
        step += 1
        before = ev.export_arrays(t.cfg, t.state)
        acc_before = t.slots["accum"][:-1][ht.live_mask(t.state.table)]
        with captured_probes() as inserts:
            t0 = time.perf_counter()
            grew = t.maybe_grow()
            _sync(dev)
            grow_s = time.perf_counter() - t0
        if step > 8:
            raise AssertionError(f"phase {label}: no growth in {step} steps")
    after = ev.export_arrays(t.cfg, t.state)
    o_b, o_a = np.argsort(before["keys"]), np.argsort(after["keys"])
    acc_after = t.slots["accum"][:-1][ht.live_mask(t.state.table)]
    if not (np.array_equal(before["keys"][o_b], after["keys"][o_a])
            and np.array_equal(before["values"][o_b], after["values"][o_a])
            and np.array_equal(before["freqs"][o_b], after["freqs"][o_a])
            and np.array_equal(acc_before.cpu().numpy()[o_b],
                               acc_after.cpu().numpy()[o_a])):
        raise AssertionError(f"phase {label}: rows did not survive growth")
    hi, lo = keylib.split_ids(after["keys"])
    qhi, qlo = (torch.from_numpy(x).to(dev) for x in (hi, lo))
    with captured_probes() as finds:
        slots = ht.find(t.state.table, qhi, qlo,
                        max_probes=t.cfg.max_probes)
    if not bool((slots < t.capacity).all()):
        raise AssertionError(f"phase {label}: the regrown table lost keys")
    # One more training step on the regrown table.
    lk = t.lookup_train(qhi[:TENSIBLE_BATCH], qlo[:TENSIBLE_BATCH],
                        torch.ones(min(TENSIBLE_BATCH, qhi.numel()),
                                   dtype=torch.int32, device=dev), step)
    t.apply_gradients(lk, torch.zeros_like(lk.rows), step)
    launches = _zoo_counts()                     # the main path ends here
    if min(launches[k] for k in ("gather_rows", "adagrad_apply_rows",
                                 "hash_probe_insert", "hash_probe_find",
                                 "init_fresh_rows")) < 1:
        raise AssertionError(f"phase {label}: {launches}")
    ins = compare_probes(f"{label} growth re-insert",
                         _largest(inserts, VARIANT_LIMIT,
                                  lambda a: a[2].numel()))
    fin = compare_probes(f"{label} regrown find", finds)
    log(f"phase {label}: TensibleEV [{TENSIBLE_CAPACITY}, {TENSIBLE_DIM}] "
        f"grew to {t.capacity} after {step} steps of {TENSIBLE_BATCH} "
        f"unseen ids ({after['keys'].size} keys, generation "
        f"{t.generation}) in {grow_s:.3f} s (export, P1 re-insert in "
        f"chunks of 8,192, scatter of rows and accumulators); every key's "
        f"row, freq and accumulator equal after it; P1 finds every key "
        f"in the regrown table; launches {launches}")
    path = "table_variants/tensible"
    return [_probe_record(path, launches, ins),
            _probe_record(path, launches, fin, kind="find")]


def _variants_mesh_run(mesh, tmp: str) -> dict:
    """(f) of phase 24 on one rank: the adaptive and dyn-dim-hot models
    sharded over ``mesh`` against the unsharded models on the same
    global batches, both on this rank's card."""
    from deeprec_tpu_torch.train import loop
    tz = _train_zoo()
    dev, S, r = mesh.device, mesh.size, mesh.rank
    out = {}
    for kind in ("adaptive", "dyn_dim_hot"):
        label = f"24 (f) {kind} rank {r} of {S}"
        tr = _variant_trainer(tz, kind, dev, mesh=mesh)
        ref = _variant_trainer(tz, kind, dev)
        ref_batches = [ref.next_batch() for _ in range(VARIANT_MESH_STEPS
                                                        + 1)]
        batches = [tr.next_batch() for _ in range(VARIANT_MESH_STEPS + 1)]
        _zoo_counts(reset=True)                  # the main path starts here
        losses = []
        for b in batches[:VARIANT_MESH_STEPS]:
            tr.ts, m = tr.step(tr.ts, b)
            losses.append(float(m["loss"]))
        logits = loop.make_eval_step(tr.group, tr.apply_fn, mesh)(
            tr.ts, batches[-1]).float()
        launches = _zoo_counts()                 # the main path ends here
        if min(launches[k] for k in ("gather_rows", "adagrad_apply_rows",
                                     "hash_probe_insert", "hash_probe_find",
                                     "init_fresh_rows")) < 1:
            raise AssertionError(f"phase {label}: {launches}")
        ref_losses = []
        for b in ref_batches[:VARIANT_MESH_STEPS]:
            ref.ts, m = ref.step(ref.ts, b)
            ref_losses.append(float(m["loss"]))
        np.testing.assert_allclose(losses, ref_losses,
                                   rtol=SHARDED_LOSS_RTOL,
                                   err_msg=f"phase {label}: loss")
        row_err, bit_equal = 0.0, losses == ref_losses
        for t, cfg in tr.group.tables.items():
            k_m, v_m = _table_keys_rows(cfg, tr.ts.ev[t])
            k_r, v_r = _table_keys_rows(ref.group.tables[t], ref.ts.ev[t],
                                        (r, S))
            if not np.array_equal(k_m, k_r):
                raise AssertionError(f"phase {label}: table {t}: key sets "
                                     f"differ")
            np.testing.assert_allclose(v_m, v_r, **SHARDED_ROW_TOL,
                                       err_msg=f"phase {label}: rows of {t}")
            if v_m.size:
                row_err = max(row_err, float(np.abs(v_m - v_r).max()))
            bit_equal = bit_equal and np.array_equal(v_m, v_r)
        want = loop.make_eval_step(ref.group, ref.apply_fn)(
            ref.ts, ref_batches[-1]).float()[r * ZOO_BATCH:
                                             (r + 1) * ZOO_BATCH]
        eval_err = float((logits - want).abs().max())
        if not eval_err <= SHARDED_LOGIT_ATOL:
            raise AssertionError(f"phase {label}: eval logits differ by "
                                 f"{eval_err}")
        bit_equal = bit_equal and eval_err == 0.0
        out[kind] = {"losses": losses, "ref_losses": ref_losses,
                     "row_err": row_err, "eval_err": eval_err,
                     "bit_equal": bool(bit_equal), "launches": launches,
                     "placement": tr.group.placement_plan()}
        del tr, ref, batches, ref_batches
        _release()
    return out


def _variants_rank(rank, world, tmp, card, draws):
    """A spawned NCCL rank of phase 24 (f); writes its results to
    ``tmp/variants-r<rank>.json``."""
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from deeprec_tpu_torch.parallel import mesh as meshlib
    from deeprec_tpu_torch.parallel import multihost
    CARD.update(card)
    DRAW_INSTRUCTIONS.update(draws)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(
        backend="nccl", rank=rank, world_size=world, device="cuda",
        init_method="file://" + os.path.join(tmp, "store-variants"))
    try:
        out = _variants_mesh_run(meshlib.data_mesh(world), tmp)
        with open(os.path.join(tmp, f"variants-r{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def phase_variants(tmp: str, gather_err: float, apply_err: float,
                   device="cuda") -> list:
    """Phase 24 (r): the table and column variants; see the module's
    docstring. Returns the kernels' records of the ``table_variants/*``
    paths."""
    label = "24 (r)"
    dev = torch.device(device)
    t_phase = time.perf_counter()
    records, adaptive_ms, epoch = _variant_adaptive(
        tmp, dev, gather_err, apply_err, label)
    summary = {"adaptive_step_ms": round(adaptive_ms, 3)}
    if epoch:
        summary["adaptive_epoch"] = {k: round(v, 4) for k, v in
                                     epoch.items()}
    for kind, sparse, part in (("dyn_dim", "adagrad", "c"),
                               ("dyn_dim", "adam", "c"),
                               ("dyn_dim_hot", "adagrad", "d")):
        recs, ms = _variant_dyn_dim(kind, sparse, dev, gather_err,
                                    apply_err, f"{label} ({part})")
        records += recs
        summary[f"{kind}_{sparse}_step_ms"] = round(ms, 3)
    records += _variant_tensible(dev, f"{label} (e)")
    if dev.type == "cuda":
        import torch.multiprocessing as mp
        world = torch.cuda.device_count()
        t0 = time.perf_counter()
        mp.spawn(_variants_rank, nprocs=world, join=True, args=(
            world, tmp, dict(CARD), dict(DRAW_INSTRUCTIONS)))
        launches = {}
        for r in range(world):
            with open(os.path.join(tmp, f"variants-r{r}.json")) as f:
                res = json.load(f)
            for kind, v in res.items():
                places = {}
                for p in v["placement"].values():
                    places[p] = places.get(p, 0) + 1
                log(f"phase {label} (f) nccl rank {r} of {world}: {kind}, "
                    f"tables {places}: losses {v['losses']} "
                    f"(unsharded {v['ref_losses']}); rows' max abs diff "
                    f"{v['row_err']:.3g}, eval logits {v['eval_err']:.3g}; "
                    f"bit-equal to the unsharded model: {v['bit_equal']}; "
                    f"launches {v['launches']}")
                for k, n in v["launches"].items():
                    launches[k] = launches.get(k, 0) + n
        log(f"phase {label} (f): {world} rank(s) in "
            f"{time.perf_counter() - t0:.3f} s")
        path = "table_variants/mesh"
        for rec in [x for x in records
                    if x["path"] == "table_variants/adaptive"]:
            base = rec["name"].split("[")[0]
            records.append(dict(rec, name=f"{base}[{path}]", path=path,
                                launches=launches[base],
                                times_from="table_variants/adaptive"))
    log(f"phase {label}: table variants in "
        f"{time.perf_counter() - t_phase:.3f} s; {json.dumps(summary)}")
    return records


@contextlib.contextmanager
def counting_syncs(dev):
    """Host syncs inside the block, by the line of the port that waited
    (the sync debug mode's warnings, as
    ``tools/profile_train_torch.count_syncs`` counts a step's); the
    Counter fills when the block ends. Nothing is counted on the CPU."""
    counts = collections.Counter()
    if dev.type != "cuda":
        yield counts
        return
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield counts
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        msg = str(w.message)
        if "synchroniz" not in msg or "prototype" in msg:
            continue
        counts[f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"] += 1


def _timed_part(dev, fn):
    """``(fn(), CUDA events around it or None, host wall ms, host syncs
    in it)``."""
    events = None
    if dev.type == "cuda":
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
    t0 = time.perf_counter()
    with counting_syncs(dev) as syncs:
        out = fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    if events is not None:
        events[1].record()
    return out, events, host_ms, syncs


def _tier_storage(disk_path=None):
    """Phase 25's storage by table width: both tables ``HBM_HOST``; with
    ``disk_path``, the 65-wide one ``HBM_HOST_DISK`` there, at
    ``TIER_HOST_CAPACITY`` rows of host RAM."""
    from deeprec_tpu_torch import config as cfglib
    host = cfglib.StorageOption(storage_type=cfglib.StorageType.HBM_HOST)
    if disk_path is None:
        return {129: host, 65: host}
    return {129: host, 65: cfglib.StorageOption(
        storage_type=cfglib.StorageType.HBM_HOST_DISK,
        storage_path=disk_path, host_capacity=TIER_HOST_CAPACITY)}


def _tier_trainer(dev, storage, sparse_opt="adagrad", mesh=None):
    """The headline WDL (``bench.build_wdl``) with tiered tables."""
    from deeprec_tpu_torch import bench
    return bench.build_wdl(device=dev, sparse_opt=sparse_opt, mesh=mesh,
                           storage=storage)


def _tier_raws(n: int, vocab=TIER_VOCAB, seed=TIER_SEED, rows=BATCH):
    """``n`` raw batches of a fresh ``SyntheticCriteo`` stream."""
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    data = SyntheticCriteo(rows, vocab=vocab, seed=seed)
    return [data.next_batch_np(wide=False) for _ in range(n)]


def _width(cfg) -> str:
    return f"{cfg.dim}-wide"


class _RoundTrip:
    """The round-trip gate of one tiered table: the rows of its first
    demotion (the spill tiers' export right after it: value rows, freqs,
    versions, optimizer slot rows), each checked on the card on its
    first promotion, bit for bit. The check reads the card through the
    plain probe (``hash_table.find_reference``), so it launches no
    kernel. A recorded key that comes back otherwise (a lookup inserted
    it fresh while a capped promotion left it in the tiers; its spill
    copy is then dropped as stale) leaves the record unchecked."""

    def __init__(self, tname, tiered_table):
        self.tname, self.t = tname, tiered_table
        self.rec, self.cand = None, None
        self.checked = self.from_disk = 0
        self.recorded = 0

    def _in_store(self, ids):
        hit = self.t.host.contains_batch(ids)
        if self.t.cold is not None and len(self.t.cold):
            hit |= self.t.cold.contains_batch(ids)
        return hit

    def _keep(self, mask):
        self.rec = {k: v[mask] for k, v in self.rec.items()}

    def _slots(self, state, ids):
        from deeprec_tpu_torch.embedding import hash_table as ht
        from deeprec_tpu_torch.utils import keys as keylib
        dev = state.values.device
        hi, lo = keylib.split_ids(ids)
        return ht.find_reference(state.table, torch.from_numpy(hi).to(dev),
                                 torch.from_numpy(lo).to(dev),
                                 self.t.cfg.max_probes).cpu().numpy()

    def after_post(self):
        if self.rec is None and self.t.stats.demoted:
            rec = self.t.export_spill()
            order = np.argsort(rec["keys"], kind="stable")
            self.rec = {k: v[order] for k, v in rec.items()}
            self.recorded = int(order.size)

    def before_pre(self, state, batch_ids):
        """The recorded keys ``pre_step`` may promote: in a tier, asked
        by the batch, not resident (a resident one's copy is stale:
        dropped from the record)."""
        self.cand = None
        if self.rec is None or not self.rec["keys"].size:
            return
        self._keep(self._in_store(self.rec["keys"]))
        want = np.isin(self.rec["keys"], batch_ids)
        if not want.any():
            return
        cand = self.rec["keys"][want]
        resident = self._slots(state, cand) < self.t.cfg.capacity
        self._keep(~np.isin(self.rec["keys"], cand[resident]))
        self.cand = cand[~resident]
        self.cand_cold = ~self.t.host.contains_batch(self.cand)

    def after_pre(self, state, slot_state, label):
        """Compare the candidates that left the tiers (promoted) with
        their record."""
        if self.cand is None or not self.cand.size:
            return
        gone = ~self._in_store(self.cand)
        ids = self.cand[gone]
        if not ids.size:
            return
        slots = self._slots(state, ids)
        if not (slots < self.t.cfg.capacity).all():
            raise AssertionError(f"phase {label}: {self.tname}: promoted "
                                 f"keys missing from the table")
        idx = torch.from_numpy(slots).to(state.values.device).long()
        pos = np.searchsorted(self.rec["keys"], ids)
        got = {"values": state.values[idx], "freqs": state.freqs[idx],
               "versions": state.versions[idx]}
        for k in self.rec:
            if k.startswith("slot/"):
                got[k] = slot_state[k[len("slot/"):]][idx]
        for k, v in got.items():
            have = v.cpu().numpy()
            want = self.rec[k][pos]
            if not np.array_equal(have.view(np.uint8), want.view(np.uint8)):
                raise AssertionError(
                    f"phase {label}: {self.tname}: {k} of promoted keys "
                    f"differs from their demoted bits")
        self.checked += int(ids.size)
        self.from_disk += int(self.cand_cold[gone].sum())

    def after_step(self):
        """Drop this batch's candidates: the promoted ones are checked,
        and the step's lookup inserts the others fresh (their spill
        copies go stale)."""
        if self.cand is not None:
            self._keep(~np.isin(self.rec["keys"], self.cand))
            self.cand = None


def _tier_loop(label, tr, tiered, raws, dev, gates=()):
    """``tiered.pre_step`` (on the raw batch: its ids stay on the host),
    the train step and ``tiered.post_step`` over ``raws``; per step a
    line: loss, ``n_overflow``, each tiered table's promoted, demoted,
    paged-down, spill and disk rows, and of each part the ms between
    CUDA events, the host's wall ms and the host syncs. Returns the
    per-step rows."""
    out = []
    for i, raw in enumerate(raws):
        batch = tr.group.pack_batch_np(raw, tr.device)
        before = tiered.stats()
        for g in gates:
            g.before_pre(tr.ts.ev[g.tname],
                         tiered._batch_ids_for(g.tname, raw))
        _, e_pre, h_pre, s_pre = _timed_part(
            dev, lambda: tiered.pre_step(tr.ts, raw))
        for g in gates:
            g.after_pre(tr.ts.ev[g.tname], tr.ts.slots[g.tname], label)
        (tr.ts, m), e_step, h_step, s_step = _timed_part(
            dev, lambda: tr.step(tr.ts, batch))
        for g in gates:
            g.after_step()
        _, e_post, h_post, s_post = _timed_part(
            dev, lambda: tiered.post_step(tr.ts))
        for g in gates:
            g.after_post()
        loss, over = float(m["loss"]), int(m["n_overflow"])
        _sync(dev)
        if not np.isfinite(loss):
            raise AssertionError(f"phase {label}: loss {loss} at step {i}")
        dev_ms = [e[0].elapsed_time(e[1]) if e is not None else None
                  for e in (e_pre, e_step, e_post)]
        tables = {}
        for t, st in tiered.stats().items():
            b = before[t]
            tables[_width(tr.group.tables[t])] = {
                "promoted": st.promoted - b.promoted,
                "demoted": st.demoted - b.demoted,
                "paged_down": st.paged_down - b.paged_down,
                "spill_rows": st.spill_rows, "disk_rows": st.disk_rows}
        row = {"loss": loss, "n_overflow": over, "tables": tables,
               "device_ms": dev_ms, "host_ms": [h_pre, h_step, h_post],
               "syncs": [sum(s.values()) for s in (s_pre, s_step, s_post)],
               "sync_sites": dict(s_pre + s_step + s_post)}
        out.append(row)
        log(f"phase {label} step {i + 1}/{len(raws)}: loss {loss:.6f}, "
            f"n_overflow {over}; {json.dumps(tables)}; pre_step / step / "
            f"post_step ms between CUDA events {dev_ms}, host wall ms "
            f"{[round(h, 3) for h in row['host_ms']]}, host syncs "
            f"{row['syncs']} {row['sync_sites']}")
    return out


def _tier_summary(rows) -> dict:
    """Medians of a run's per-part times and the syncs a step."""
    def med(key, j, pick=lambda r: True):
        xs = [r[key][j] for r in rows if pick(r) and r[key][j] is not None]
        return float(np.median(xs)) if xs else None

    demoting = lambda r: any(t["demoted"] for t in r["tables"].values())  # noqa
    promoting = lambda r: any(t["promoted"] for t in r["tables"].values())  # noqa
    return {"pre_device_ms": med("device_ms", 0),
            "pre_host_ms": med("host_ms", 0),
            "pre_host_ms_promoting": med("host_ms", 0, promoting),
            "step_device_ms": med("device_ms", 1),
            "post_host_ms_demoting": med("host_ms", 2, demoting),
            "post_device_ms_demoting": med("device_ms", 2, demoting),
            "syncs_per_step": [max(r["syncs"][j] for r in rows)
                               for j in range(3)],
            "n_overflow": [r["n_overflow"] for r in rows]}


def _gates(tiered):
    return [_RoundTrip(t, tt) for t, tt in tiered.tiered.items()]


def _check_gates(label, gates, min_keys=TIER_GATE_KEYS, from_disk=False):
    checked = sum(g.checked for g in gates)
    disk = sum(g.from_disk for g in gates)
    log(f"phase {label}: round trip: " + "; ".join(
        f"{g.tname}: {g.recorded} keys recorded at its first demotion, "
        f"{g.checked} checked on their first promotion ({g.from_disk} "
        f"from disk), all bit-equal (values, freqs, versions, slot rows)"
        for g in gates))
    if checked < min_keys or (from_disk and disk < 1):
        raise AssertionError(f"phase {label}: {checked} keys checked "
                             f"({disk} from disk); want {min_keys} or more"
                             + (" and one from disk" if from_disk else ""))


def _tier_kernels(tr, tiered, pool, kind, label):
    """The kernels on the tiered path's own operands, each against its
    plain version and timed: one more ``pre_step`` of the batch of
    ``pool`` whose ids the tiers hold most of (P1's insert of the
    promotion into the table the last demotion tombstoned, P1's find of
    the resident check), then that batch's step (K1's fetch of the
    promoted rows, K2 or K3 applied to them, P1, P2). Returns (promotion
    probes, resident finds, fetch, applies, step probes, draws)."""
    def held(raw):
        n = 0
        for t, tt in tiered.tiered.items():
            ids = tiered._batch_ids_for(t, raw)
            n += int(tt.host.contains_batch(ids).sum())
            if tt.cold is not None and len(tt.cold):
                n += int(tt.cold.contains_batch(ids).sum())
        return n

    raw = max(pool, key=held)
    with captured_probes() as probes:
        tiered.pre_step(tr.ts, raw)
    inserts = [p for p in probes if p[0] == "insert"]
    finds = [p for p in probes if p[0] == "find"]
    if not (inserts and finds):
        raise AssertionError(f"phase {label}: the extra pre_step made "
                             f"{len(inserts)} promotion inserts and "
                             f"{len(finds)} resident checks")
    promo = compare_probes(f"{label} promotion into the demoted table",
                           inserts)
    resident = compare_probes(f"{label} resident check", finds)
    fetch, applies, step_probes, draws = _compare_step_kernels(
        tr, kind, label, tr.group.pack_batch_np(raw, tr.device))
    return promo, resident, fetch, applies, step_probes, draws


def _by_key(arrays) -> dict:
    order = np.argsort(arrays["keys"], kind="stable")
    return {k: np.asarray(v)[order] for k, v in arrays.items()}


def _equal_by_key(a, b) -> bool:
    a, b = _by_key(a), _by_key(b)
    return sorted(a) == sorted(b) and all(
        np.array_equal(a[k].view(np.uint8), b[k].view(np.uint8))
        for k in a)


def _tier_checkpoint(tr, tiered, tmp, label, dev):
    """(c): a full save with the spill files, restored into fresh tables
    and a fresh tiered group: every table's rows, freqs, versions and
    slot rows, and every spill store, equal key by key, bit for bit."""
    from deeprec_tpu_torch.embedding import multi_tier as mt
    from deeprec_tpu_torch.train import checkpoint as ckptlib
    d = os.path.join(tmp, "tiered_ckpt")
    mgr = ckptlib.CheckpointManager(d, tr.group)
    mgr.attach_tiered(tiered)
    t0 = time.perf_counter()
    path = mgr.save(tr.ts)
    save_s = time.perf_counter() - t0
    fresh = mt.TieredGroup(tr.group, tr.ts.slots, high_watermark=0.85,
                           low_watermark=0.70, demote_every=4)
    mgr = ckptlib.CheckpointManager(d, tr.group)
    mgr.attach_tiered(fresh)
    t0 = time.perf_counter()
    ts2 = mgr.restore(tr.ts)
    _sync(dev)
    restore_s = time.perf_counter() - t0
    for t, cfg in tr.group.tables.items():
        a = ckptlib._export_table(cfg, tr.ts.ev[t], tr.ts.slots[t], None)
        b = ckptlib._export_table(cfg, ts2.ev[t], ts2.slots[t], None)
        if not _equal_by_key(a, b):
            raise AssertionError(
                f"phase {label}: table {t} restored unequal: "
                f"{a['keys'].size} keys saved, {b['keys'].size} restored "
                f"of {cfg.capacity} slots")
    for t, tt in tiered.tiered.items():
        if not _equal_by_key(tt.export_spill(),
                             fresh.tiered[t].export_spill()):
            raise AssertionError(f"phase {label}: spill store of {t} "
                                 f"restored unequal")
    files = sorted(f for f in os.listdir(path) if f.startswith("spill-"))
    nbytes = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path))
    log(f"phase {label}: full save with {files} ({nbytes} bytes) in "
        f"{save_s:.3f} s, restore into fresh tables and a fresh tiered "
        f"group in {restore_s:.3f} s: every table (keys, rows, freqs, "
        f"versions, accumulators) and spill store equal, key by key, bit "
        f"for bit")
    del ts2, fresh
    shutil.rmtree(d, ignore_errors=True)
    return {"save_s": save_s, "restore_s": restore_s, "bytes": nbytes}


def _tier_two(tmp, dev, gather_err, apply_err, label="25 (a)"):
    """(a) two tiers, (c) the checkpoint, and the kernels' comparisons;
    returns the kernels' records and a summary."""
    from deeprec_tpu_torch import bench
    from deeprec_tpu_torch.embedding import multi_tier as mt
    raws = _tier_raws(TIER_STEPS)
    ref = bench.build_wdl(device=dev)
    untiered = []
    for raw in raws:
        ref.ts, m = ref.step(ref.ts, ref.group.pack_batch_np(raw, dev))
        untiered.append(int(m["n_overflow"]))
    log(f"phase {label}: the same {TIER_STEPS} batches without tiers: "
        f"n_overflow a step {untiered}")
    del ref
    _release()
    tr = _tier_trainer(dev, _tier_storage())
    tiered = mt.TieredGroup(tr.group, tr.ts.slots, high_watermark=0.85,
                            low_watermark=0.70, demote_every=4)
    gates = _gates(tiered)
    _zoo_counts(reset=True)                    # the tiered path starts here
    rows = _tier_loop(label, tr, tiered, raws + raws[:TIER_REFEED], dev,
                      gates)
    launches = _zoo_counts()                   # the tiered path ends here
    need = ("gather_rows", "adagrad_apply_rows", "hash_probe_insert",
            "hash_probe_find", "init_fresh_rows")
    if min(launches[k] for k in need) < 1:
        raise AssertionError(f"phase {label}: {launches}")
    _check_gates(label, gates)
    summary = _tier_summary(rows)
    summary["untiered_n_overflow"] = untiered
    log(f"phase {label}: launches {launches}; {json.dumps(summary)}")
    summary["checkpoint"] = _tier_checkpoint(tr, tiered, tmp, "25 (c)", dev)
    promo, resident, fetch, applies, probes, draws = _tier_kernels(
        tr, tiered, raws[TIER_REFEED:2 * TIER_REFEED], "adagrad", label)
    del tr, tiered, gates
    _release()
    records = (_path_records("tiered", launches, fetch, applies, gather_err,
                             apply_err, probes=probes, draws=draws)
               + [_probe_record("tiered/promotion", launches, promo),
                  _probe_record("tiered", launches, resident, kind="find")])
    return records, summary


def _tier_three(dev, label="25 (b)"):
    """(b) the 65-wide table on three tiers, its disk tier in a new
    directory under $TMPDIR, removed after the run."""
    from deeprec_tpu_torch.embedding import multi_tier as mt
    disk = tempfile.mkdtemp(prefix="chip_smoke_cold_")
    try:
        tr = _tier_trainer(dev, _tier_storage(disk))
        tiered = mt.TieredGroup(tr.group, tr.ts.slots, high_watermark=0.85,
                                low_watermark=0.70, demote_every=4)
        gates = _gates(tiered)
        raws = _tier_raws(TIER_DISK_STEPS)
        _zoo_counts(reset=True)
        rows = _tier_loop(label, tr, tiered, raws + raws[:TIER_REFEED], dev,
                          gates)
        launches = _zoo_counts()
        _check_gates(label, gates, min_keys=1, from_disk=True)
        nbytes = sum(os.path.getsize(os.path.join(r, f))
                     for r, _, fs in os.walk(disk) for f in fs)
        summary = _tier_summary(rows)
        summary.update(disk_bytes=nbytes, stats={
            _width(tr.group.tables[t]): vars(st)
            for t, st in tiered.stats().items()})
        log(f"phase {label}: launches {launches}; disk tier files "
            f"{nbytes} bytes; {json.dumps(summary)}")
        del tr, tiered, gates
        _release()
        return summary
    finally:
        shutil.rmtree(disk, ignore_errors=True)


def _tier_adam(dev, gather_err, apply_err, label="25 (d)"):
    """(d) SparseAdam (K3): m and v round-trip; K3 on promoted rows."""
    from deeprec_tpu_torch.embedding import multi_tier as mt
    tr = _tier_trainer(dev, _tier_storage(), sparse_opt="adam")
    tiered = mt.TieredGroup(tr.group, tr.ts.slots,
                            high_watermark=TIER_SHORT_MARKS[0],
                            low_watermark=TIER_SHORT_MARKS[1],
                            demote_every=2)
    gates = _gates(tiered)
    raws = _tier_raws(TIER_SHORT[0])
    _zoo_counts(reset=True)
    rows = _tier_loop(label, tr, tiered, raws + raws[:TIER_SHORT[1]], dev,
                      gates)
    launches = _zoo_counts()
    if min(launches[k] for k in ("adam_apply_rows", "hash_probe_find",
                                 "hash_probe_insert")) < 1:
        raise AssertionError(f"phase {label}: {launches}")
    _check_gates(label, gates)
    log(f"phase {label}: launches {launches}; "
        f"{json.dumps(_tier_summary(rows))}")
    _, _, _, applies, _, _ = _tier_kernels(tr, tiered, raws[2:], "adam",
                                           label)
    del tr, tiered, gates
    _release()
    return [_record("adam_apply_rows[tiered/adam]",
                    "deeprec_tpu_torch/csrc/sparse_apply.cu",
                    "deeprec_tpu/ops/pallas/sparse_apply.py:253",
                    launches["adam_apply_rows"],
                    max([apply_err] + [r["max_abs_err"] for r in applies]),
                    max(applies, key=lambda r: r["bound_ms"]),
                    "tiered/adam")]


def _tier_mesh_run(mesh, tmp) -> dict:
    """(e) on one rank: the tiered headline trained sharded over ``mesh``
    on the headline's own stream, its ``TieredGroup``'s mesh branch (the
    ids all-gathered, the rank promoting those it owns) held at every
    ``pre_step`` and ``post_step`` against the unsharded branch run on a
    copy of the same state (the device tables and slots copied into an
    unsharded trainer's just before): the tables, slot rows, spill tiers
    and tier stats after each must be bit-equal. (A whole unsharded run
    is no reference here: its inserts claim other slots than the
    sharded step's, and LRU demotion breaks ties of equal versions by
    slot, so the two demote other keys.) The ``pre_step`` all-gathers
    are counted."""
    from deeprec_tpu_torch.data.criteo import CRITEO_HASH_BUCKETS
    from deeprec_tpu_torch.embedding import multi_tier as mt
    dev, S, r = mesh.device, mesh.size, mesh.rank
    label = f"25 (e) rank {r} of {S}"
    tr = _tier_trainer(dev, _tier_storage(), mesh=mesh)
    ref = _tier_trainer(dev, _tier_storage())
    kw = dict(high_watermark=TIER_MESH_MARKS[0],
              low_watermark=TIER_MESH_MARKS[1], demote_every=2)
    tiered = mt.TieredGroup(tr.group, tr.ts.slots, mesh=mesh, **kw)
    rtiered = mt.TieredGroup(ref.group, ref.ts.slots, **kw)
    raws = _tier_raws(TIER_SHORT[0], vocab=CRITEO_HASH_BUCKETS, seed=0,
                      rows=BATCH * S)

    def tensors(ts):
        for t in sorted(ts.ev):
            st = ts.ev[t]
            yield from (st.table.key_rows, st.values, st.freqs, st.versions)
            yield from (ts.slots[t][k] for k in sorted(ts.slots[t]))

    def copy_state():
        for dst, src in zip(tensors(ref.ts), tensors(tr.ts)):
            dst.copy_(src)

    def check(what, i):
        same = all(torch.equal(a, b)
                   for a, b in zip(tensors(tr.ts), tensors(ref.ts)))
        for t, tt in tiered.tiered.items():
            a, b = tt.export_spill(), rtiered.tiered[t].export_spill()
            same = same and sorted(a) == sorted(b) and all(
                np.array_equal(a[k].view(np.uint8), b[k].view(np.uint8))
                for k in a) and vars(tt.stats) == vars(
                    rtiered.tiered[t].stats)
        if not same:
            raise AssertionError(f"phase {label}: step {i} {what}: the mesh "
                                 f"branch differs from the unsharded one")

    losses, gathers = [], 0
    mesh.trace = []
    for i, raw in enumerate(raws + raws[:TIER_SHORT[1]]):
        local = {k: v[r * BATCH:(r + 1) * BATCH] for k, v in raw.items()}
        copy_state()
        n0 = len(mesh.trace)
        tiered.pre_step(tr.ts, local)
        gathers += sum(x["kind"] == "all_gather" for x in mesh.trace[n0:])
        rtiered.pre_step(ref.ts, raw)
        check("pre_step", i)
        tr.ts, m = tr.step(tr.ts, tr.group.pack_batch_np(local, dev))
        copy_state()
        tiered.post_step(tr.ts)
        rtiered.post_step(ref.ts)
        check("post_step", i)
        losses.append(float(m["loss"]))
    mesh.trace = None
    stats = {t: vars(st) for t, st in tiered.stats().items()}
    demoted = sum(st["demoted"] for st in stats.values())
    promoted = sum(st["promoted"] for st in stats.values())
    if not (demoted and promoted and gathers and np.isfinite(losses).all()):
        raise AssertionError(f"phase {label}: demoted {demoted}, promoted "
                             f"{promoted}, all-gathers {gathers}, losses "
                             f"{losses}")
    return {"losses": losses, "stats": stats, "gathers": gathers}


def _tier_rank(rank, world, tmp, card, draws):
    """The spawned NCCL rank of phase 25 (e); writes its results to
    ``tmp/tier-r<rank>.json``."""
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from deeprec_tpu_torch.parallel import mesh as meshlib
    from deeprec_tpu_torch.parallel import multihost
    CARD.update(card)
    DRAW_INSTRUCTIONS.update(draws)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(
        backend="nccl", rank=rank, world_size=world, device="cuda",
        init_method="file://" + os.path.join(tmp, "store-tier"))
    try:
        out = _tier_mesh_run(meshlib.data_mesh(world), tmp)
        with open(os.path.join(tmp, f"tier-r{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def phase_tiered(tmp: str, gather_err: float, apply_err: float,
                 device="cuda") -> list:
    """Phase 25 (s): multi-tier storage; see the module's docstring.
    Returns the kernels' records of the ``tiered*`` paths."""
    dev = torch.device(device)
    t_phase = time.perf_counter()
    records, summary = _tier_two(tmp, dev, gather_err, apply_err)
    summary["three_tier"] = _tier_three(dev)
    records += _tier_adam(dev, gather_err, apply_err)
    if dev.type == "cuda":
        import torch.multiprocessing as mp
        t0 = time.perf_counter()
        mp.spawn(_tier_rank, nprocs=1, join=True, args=(
            1, tmp, dict(CARD), dict(DRAW_INSTRUCTIONS)))
        with open(os.path.join(tmp, "tier-r0.json")) as f:
            res = json.load(f)
        log(f"phase 25 (e) nccl rank 0 of 1: losses {res['losses']}; "
            f"pre_step all-gathers {res['gathers']}; tier stats "
            f"{res['stats']}; the mesh branch bit-equal to the unsharded "
            f"one at every pre_step and post_step; "
            f"{time.perf_counter() - t0:.3f} s")
    log(f"phase 25 (s): multi-tier storage in "
        f"{time.perf_counter() - t_phase:.3f} s")
    return records


# -- phase 26 (t): the rest of serving ----------------------------------------

def _serve_parts(device="cuda", extra=None):
    from deeprec_tpu_torch.serving import wdl_entry
    return wdl_entry.build({"device": device, **SERVE_CONFIG,
                            **(extra or {})})


def _serve_rows(raw, start: int, n: int) -> dict:
    return {k: v[start:start + n] for k, v in raw.items()}


def _kserve_specs(kserve):
    from deeprec_tpu_torch.data.criteo import NUM_CAT, NUM_INT
    return ([kserve.TensorSpec(f"I{i}", "numeric")
             for i in range(1, NUM_INT + 1)]
            + [kserve.TensorSpec(f"C{i}", "id", dims=(1,))
               for i in range(1, NUM_CAT + 1)])


def _kserve_request(raw, start: int, n: int) -> dict:
    rows = _serve_rows(raw, start, n)
    return {"id": f"rows-{start}", "inputs": [
        {"name": k, "shape": list(rows[k].shape),
         "datatype": "FP32" if k.startswith("I") else "INT64",
         "data": rows[k].reshape(-1).tolist()}
        for k in sorted(rows) if k[0] in "IC"]}


def _serving_records(path, launches, fetch, finds, gather_err):
    """K1 and P1 ``find`` records of a serving path: launches from its
    run, times and bound from its largest operands."""
    return [
        _record(f"gather_rows[{path}]", "deeprec_tpu_torch/csrc/gather_rows.cu",
                "deeprec_tpu/ops/pallas/gather.py:72", launches["gather_rows"],
                gather_err, max(fetch, key=lambda r: r["bound_ms"]), path),
        _probe_record(path, launches, finds, kind="find")]


def _compare_serving_kernels(label, fn):
    """K1 and P1 on the operands ``fn()`` gives them, each against its
    plain version and timed: ``(fetch records, find records)``."""
    with captured_gathers() as calls, captured_probes() as probes:
        fn()
    fetch = [compare_gather(f"{label} fetch", *args) for args in calls]
    return fetch, compare_probes(f"{label} probe", probes)


def _serve_kserve(serving, group, raw, gather_err):
    """26 (a): warmup, then 512-row requests through the KServe front."""
    from deeprec_tpu_torch.ops.kernels import gather, hash_probe
    from deeprec_tpu_torch.serving import kserve
    warm = [group.pack_batch_np(_serve_rows(raw, SERVE_ROWS * i, SERVE_ROWS),
                                "cpu") for i in range(2)]
    version = serving.version
    warm_s = serving.warmup(warm)
    if not warm_s > 0 or serving.version != version:
        raise AssertionError(f"warmup: {warm_s} s, version {version} -> "
                             f"{serving.version}")
    front = kserve.KServeFrontend(serving, "wdl", _kserve_specs(kserve))
    front.start()
    url = f"http://127.0.0.1:{front.port}/v2/models/wdl"
    try:
        with urllib.request.urlopen(url + "/ready", timeout=60) as r:
            if r.status != 200:
                raise AssertionError(f"KServe ready: {r.status}")
        reqs = [_kserve_request(raw, SERVE_ROWS * i, SERVE_ROWS)
                for i in range(SERVE_REQUESTS)]
        gather.launches = 0                   # the main path starts here
        hash_probe.launches["find"] = 0
        lat, outs = [], []
        for req in reqs:
            body = urllib.request.Request(
                url + "/infer", data=json.dumps(req).encode(),
                headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(body, timeout=300) as r:
                outs.append(json.loads(r.read()))
            lat.append(time.perf_counter() - t0)
        launches = {"gather_rows": gather.launches,
                    "hash_probe_find": hash_probe.launches["find"]}
        if min(launches.values()) < 1:        # the main path ends here
            raise AssertionError(f"the KServe path did not launch every "
                                 f"kernel: {launches}")
        for i, out in enumerate(outs):
            want = kserve.sigmoid_scores(serving.predict(group.pack_batch_np(
                _serve_rows(raw, SERVE_ROWS * i, SERVE_ROWS), "cpu")))
            got = out["outputs"][0]["data"]
            if got != want.tolist():
                raise AssertionError(
                    f"KServe request {i} vs in-process predict: max abs "
                    f"diff {float(np.abs(np.asarray(got) - want).max())}")
        fetch, finds = _compare_serving_kernels(
            "26 (a) kserve", lambda: front.infer(reqs[0]))
    finally:
        front.stop()
    log(f"phase 26 (a) kserve: warmup of 2 x {SERVE_ROWS} rows "
        f"{warm_s:.3f} s (version {version} kept); {SERVE_REQUESTS} "
        f"/infer requests of {SERVE_ROWS} rows in ms "
        f"{[round(x * 1e3, 3) for x in lat]} (HTTP+JSON included), scores "
        f"bit-equal to the sigmoid of ServingModel.predict; launches "
        f"{launches}")
    return _serving_records("serving_kserve", launches, fetch, finds,
                            gather_err)


C_CLIENT = r'''
#include <stdio.h>
#include <stdlib.h>
#include "deeprec_client.h"
int main(int argc, char** argv) {
  static char req[1 << 22], buf[1 << 20];
  FILE* f = fopen(argv[3], "rb");
  if (!f) return 6;
  size_t n = fread(req, 1, sizeof req - 1, f);
  fclose(f);
  req[n] = '\0';
  dr_client c;
  if (dr_client_init(&c, argv[1], atoi(argv[2]), 300000)) return 2;
  if (dr_health(&c, buf, sizeof buf)) return 3;
  if (dr_predict(&c, req, buf, sizeof buf)) return 5;
  printf("%s\n", buf);
  return 0;
}
'''


def _serve_abi(serving, parts, raw, probs, ckpt_dir, tmp, gather_err):
    """26 (b): the port's C ABI processor, its worker on the card, and the
    C SDK against that worker."""
    from deeprec_tpu_torch.serving import native as proc_native
    tools = _tool("serving_benchmark_torch")

    def req(start, n):
        return {"instances": tools.instances(raw, range(start, start + n))}

    def check(what, preds, start, n):
        got = np.asarray(preds)
        if got.shape != (n,) or not ((got > 0) & (got < 1)).all():
            raise AssertionError(f"{what}: predictions {got.shape} out of "
                                 f"(0, 1)")
        diff = float(np.abs(got - probs[start:start + n]).max())
        if diff > PROB_ATOL:
            raise AssertionError(f"{what} vs in-process: max abs diff "
                                 f"{diff} > {PROB_ATOL}")
        return diff

    t0 = time.perf_counter()
    proc_native.load()
    build_s = time.perf_counter() - t0
    env_pp = os.environ.get("PYTHONPATH", "")
    os.environ["PYTHONPATH"] = os.pathsep.join([ROOT] + ([env_pp] if env_pp
                                                         else []))
    t0 = time.perf_counter()
    try:
        proc = proc_native.Processor(
            "deeprec_tpu_torch.serving.wdl_entry",
            {"checkpoint_dir": ckpt_dir, "device": serving._device.type,
             **SERVE_CONFIG, "report_launches": True})
    finally:
        os.environ["PYTHONPATH"] = env_pp
    init_s = time.perf_counter() - t0
    try:
        info = proc.model_info()
        if info != {"status": "ok", "version": serving.version}:
            raise AssertionError(f"ABI model info {info}")
        out = proc.process(req(0, ABI_ROWS))
        diffs = [check("process", out["predictions"], 0, ABI_ROWS)]
        outs = proc.batch_process([req(ABI_ROWS, ABI_ROWS),
                                   req(2 * ABI_ROWS, ABI_ROWS)])
        for i, o in enumerate(outs):
            diffs.append(check("batch_process", o["predictions"],
                               (i + 1) * ABI_ROWS, ABI_ROWS))
        lat = {}
        for n in (1, ABI_ROWS):
            r_ = req(0, n)
            proc.process(r_)
            times = []
            for _ in range(ABI_REPS):
                t1 = time.perf_counter()
                last = proc.process(r_)
                times.append(time.perf_counter() - t1)
            lat[n] = (float(np.median(times)) * 1e3,
                      float(np.percentile(times, 99)) * 1e3)
        launches = last["launches"]           # the worker's, since its start
        if min(launches.values()) < 1:
            raise AssertionError(f"the ABI worker did not launch every "
                                 f"kernel: {launches}")
        sdk = os.path.join(ROOT, "deeprec_tpu_torch/serving/sdk/c")
        src, exe = (os.path.join(tmp, "abi_client.c"),
                    os.path.join(tmp, "abi_client"))
        body = os.path.join(tmp, "abi_request.json")
        with open(src, "w") as f:
            f.write(C_CLIENT)
        with open(body, "w") as f:
            json.dump(req(3 * ABI_ROWS, ABI_ROWS), f)
        subprocess.run(["gcc", "-O2", "-std=c99", "-I", sdk, "-o", exe, src,
                        os.path.join(sdk, "deeprec_client.c")], check=True,
                       capture_output=True, timeout=120)
        host, port = proc.endpoint()
        res = subprocess.run([exe, host, str(port), body],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise AssertionError(f"C SDK client exited {res.returncode}: "
                                 f"{res.stderr}")
        diffs.append(check("C SDK", json.loads(res.stdout)["predictions"],
                           3 * ABI_ROWS, ABI_ROWS))
    finally:
        proc.close()
    log(f"phase 26 (b) C ABI: shim built and loaded in {build_s:.3f} s; "
        f"initialize (worker start, restore, kernel load) {init_s:.3f} s; "
        f"process, batch_process and the C SDK of {ABI_ROWS} rows within "
        f"{max(diffs):.3g} of in-process scoring (PROB_ATOL {PROB_ATOL}); "
        f"process() p50 / p99 ms: " + ", ".join(
            f"{n} rows {a:.3f} / {b:.3f}" for n, (a, b) in lat.items())
        + f"; the worker's launches {launches}")
    # The worker launched its kernels in its own process: the same
    # request scored here gives K1 and P1 the same operands.
    fetch, finds = _compare_serving_kernels(
        "26 (b) abi", lambda: serving.predict(parts["parse_request"](
            req(0, ABI_ROWS))))
    return _serving_records("serving_abi", launches, fetch, finds,
                            gather_err)


def _touch(serving, group, batch, scale: float, step: int) -> int:
    """Rewrite every row ``batch`` reads, scaled by ``scale`` and stamped
    ``step`` (what a training update leaves); returns the keys
    touched."""
    from deeprec_tpu_torch.embedding import variable as ev
    from deeprec_tpu_torch.utils import keys as keylib
    n = 0
    for tname, tcols in group._columns_by_table().items():
        cfg, state = group.tables[tname], serving._ts.ev[tname]
        hi, lo, _ = group._packed_view(batch, tname, tcols)
        keys = np.unique(keylib.join_ids(hi.reshape(-1).cpu().numpy(),
                                         lo.reshape(-1).cpu().numpy()))
        keys = keys[keys != keylib.EMPTY_ID]
        khi, klo = keylib.split_ids(keys)
        dev = state.values.device
        rows = ev.lookup(cfg, state, torch.from_numpy(khi).to(dev),
                         torch.from_numpy(klo).to(dev)) * scale
        ev.import_arrays(cfg, state, {
            "keys": keys, "values": rows.cpu().numpy(),
            "freqs": np.ones(keys.size, np.int32),
            "versions": np.full(keys.size, step, np.int32)})
        n += keys.size
    return n


def _serve_remote(serving, group, parts, raw):
    """26 (c): the whole model into an InMemoryFeatureStore, a delta into
    the port's MiniRedisServer, RemoteServingModel against
    ServingModel. It rewrites rows of the served state: run it last."""
    from deeprec_tpu_torch.serving import feature_store as fs
    from deeprec_tpu_torch.serving.resp import MiniRedisServer
    batch = group.pack_batch_np(_serve_rows(raw, 0, SERVE_ROWS), "cpu")
    mem = fs.InMemoryFeatureStore()
    t0 = time.perf_counter()
    full = fs.publish_sparse(serving._ts, group, mem)
    full_s = time.perf_counter() - t0
    params = serving._ts.params

    def against_local(what, remote):
        got, want = remote.predict(batch), serving.predict(batch)
        diff = float((got - want).abs().max())
        if not diff <= REMOTE_LOGIT_ATOL:
            raise AssertionError(f"remote {what} vs ServingModel: max abs "
                                 f"logit diff {diff} > {REMOTE_LOGIT_ATOL}")
        return f"{diff:.3g} (bit-equal {bool(torch.equal(got, want))})"

    t0 = time.perf_counter()
    r_full = against_local("full", fs.RemoteServingModel(
        group, parts["apply_fn"], params, mem))
    remote_s = time.perf_counter() - t0
    version = serving.version
    touched = _touch(serving, group, batch, 1.5, version + 1)
    with MiniRedisServer() as srv:
        store = fs.RedisFeatureStore(srv.url, prefix="chip_smoke")
        t0 = time.perf_counter()
        delta = fs.publish_sparse(serving._ts, group, store,
                                  min_version=version + 1)
        delta_s = time.perf_counter() - t0
        if sum(delta.values()) != touched:
            raise AssertionError(f"delta published {delta}, {touched} keys "
                                 f"touched")
        r_delta = against_local("delta", fs.RemoteServingModel(
            group, parts["apply_fn"], params, store))
        cache = fs.InMemoryFeatureStore()
        cached = fs.RemoteServingModel(group, parts["apply_fn"], params,
                                       store, cache=cache)
        r_fill = against_local("cache fill", cached)
        r_hit = against_local("cache hit", cached)
        n_cached = sum(cache.num_rows(t) for t in group.tables)
    full, delta = ({f"{group.tables[t].dim} wide": n for t, n in d.items()}
                   for d in (full, delta))
    log(f"phase 26 (c) remote: published {full} rows in {full_s:.3f} s "
        f"into an InMemoryFeatureStore; a {SERVE_ROWS}-row remote request "
        f"{remote_s:.3f} s, max abs logit diff from ServingModel {r_full}; "
        f"{touched} keys rewritten at version {version + 1}, the delta "
        f"{delta} published into MiniRedisServer in {delta_s:.3f} s; "
        f"remote from Redis {r_delta}; through the cache, filling "
        f"{r_fill}, hitting {r_hit} ({n_cached} rows cached); bound "
        f"{REMOTE_LOGIT_ATOL}")


def _serving_mesh_rank(rank, world, backend, tmp, ckpt_dir, card, draws,
                       device="cuda"):
    """A spawned rank of 26 (d): ``ServingModel(mesh=)`` of the headline
    checkpoint on this rank's rows of phase 5's batch; results in
    ``tmp/serve-<backend>-r<rank>.npz``."""
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from deeprec_tpu_torch.ops.kernels import gather, hash_probe
    from deeprec_tpu_torch.parallel import mesh as meshlib
    from deeprec_tpu_torch.parallel import multihost
    from deeprec_tpu_torch.serving.processor import ServingModel
    CARD.update(card)
    DRAW_INSTRUCTIONS.update(draws)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(
        backend=backend, rank=rank, world_size=world, device=device,
        init_method="file://" + os.path.join(tmp, f"store-serve-{backend}"))
    try:
        mesh = meshlib.data_mesh(world, device=device)
        parts = _serve_parts(device, {"num_shards": world})
        group = parts["group"]
        with np.load(os.path.join(tmp, "serve_raw.npz")) as z:
            raw = dict(z)
        n = BATCH // world
        batch = group.pack_batch_np(_serve_rows(raw, rank * n, n), "cpu")
        t0 = time.perf_counter()
        serving = ServingModel(group, parts["apply_fn"], parts["ts_template"],
                               ckpt_dir, mesh=mesh)
        version = serving.full_update()
        restore_s = time.perf_counter() - t0
        gather.launches = 0                   # the main path starts here
        hash_probe.launches["find"] = 0
        logits = serving.predict(batch)
        _sync(torch.device(device))
        launches = {"gather_rows": gather.launches,
                    "hash_probe_find": hash_probe.launches["find"]}
        out = {"logits": logits.cpu().numpy(), "version": version,
               "restore_s": restore_s, "launches": json.dumps(launches)}
        if backend == "nccl":
            fetch, finds = _compare_serving_kernels(
                f"26 (d) rank {rank}", lambda: serving.predict(batch))
            out["records"] = json.dumps(_serving_records(
                "serving_mesh", launches, fetch, finds, 0.0))
        np.savez(os.path.join(tmp, f"serve-{backend}-r{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _serve_mesh(raw, logits, ckpt_dir, tmp, device="cuda"):
    """26 (d): one NCCL rank a card, then two gloo ranks on card 0 (on
    the CPU: the gloo ranks only)."""
    import torch.multiprocessing as mp
    np.savez(os.path.join(tmp, "serve_raw.npz"), **raw)
    want = logits.cpu().numpy()
    records = []
    runs = [("gloo", 2)]
    if device == "cuda":
        runs.insert(0, ("nccl", torch.cuda.device_count()))
    for backend, world in runs:
        t0 = time.perf_counter()
        mp.spawn(_serving_mesh_rank, nprocs=world, join=True, args=(
            world, backend, tmp, ckpt_dir, dict(CARD),
            dict(DRAW_INSTRUCTIONS), device))
        ranks = []
        for r in range(world):
            with np.load(os.path.join(tmp, f"serve-{backend}-r{r}.npz")) as z:
                ranks.append(dict(z))
        got = np.concatenate([res["logits"] for res in ranks])
        diff = float(np.abs(got - want).max())
        launches = [json.loads(str(res["launches"])) for res in ranks]
        if diff > SHARDED_LOGIT_ATOL or min(min(x.values())
                                            for x in launches) < 1:
            raise AssertionError(f"26 (d) {backend}: logits within {diff} of "
                                 f"phase 5's (bound {SHARDED_LOGIT_ATOL}); "
                                 f"launches {launches}")
        if backend == "nccl":
            records = json.loads(str(ranks[0]["records"]))
            for rec in records:
                key = ("gather_rows" if rec["name"].startswith("gather")
                       else "hash_probe_find")
                rec["launches"] = sum(x[key] for x in launches)
        log(f"phase 26 (d) {world} {backend} rank(s): versions "
            f"{[int(res['version']) for res in ranks]}, restore s "
            f"{[round(float(res['restore_s']), 3) for res in ranks]}; "
            f"logits against phase 5's: bit-equal "
            f"{bool(np.array_equal(got, want))}, max abs diff {diff:.3g} "
            f"(bound {SHARDED_LOGIT_ATOL}); launches {launches}; "
            f"{time.perf_counter() - t0:.3f} s")
    return records


@contextlib.contextmanager
def quantized_reads(qvalues):
    """Within the block, a ``gather_rows`` call on a table whose f32
    values are a key of ``qvalues`` (``{id(values): QuantizedEVValues}``)
    reads that table's int8 rows through ``gather_quantized`` instead,
    with the same default-row select; the rest of the eval path (P1's
    find, the bag combine, the towers) runs as it is."""
    from deeprec_tpu_torch.ops.kernels import gather
    from deeprec_tpu_torch.tools.low_precision import gather_quantized
    kernel_fn = gather.gather_rows

    def quantized(values, slots, admitted=None, bank=None, sel=None):
        qv = qvalues.get(id(values))
        if qv is None:
            return kernel_fn(values, slots, admitted, bank, sel)
        idx = torch.clamp(slots.long(), 0, values.shape[0] - 1)
        rows = gather_quantized(qv, idx)
        return gather.gather_rows_reference(
            rows, torch.arange(rows.shape[0], device=rows.device), admitted,
            bank, sel)

    gather.gather_rows = quantized
    try:
        yield
    finally:
        gather.gather_rows = kernel_fn


def _check_quantized(values, qv, chunk=1 << 20):
    """Every dequantized value within half a step (its row's scale) of
    the f32 one, plus float32 rounding; returns the worst ratio."""
    from deeprec_tpu_torch.tools.low_precision import gather_quantized
    worst = 0.0
    for a in range(0, values.shape[0], chunk):
        idx = torch.arange(a, min(a + chunk, values.shape[0]),
                           device=values.device)
        err = (gather_quantized(qv, idx) - values[idx]).abs()
        ratio = (err / qv.scale[idx]).max()
        worst = max(worst, float(ratio))
    if not worst <= LP_HALF_STEP:
        raise AssertionError(f"26 (e): a dequantized value is {worst:.4g} "
                             f"steps from its f32 value (> {LP_HALF_STEP})")
    return worst


def _serve_low_precision(serving, group, parts):
    """26 (e): both tables quantized per row to int8, scored through
    ``gather_quantized``; table bytes, ``accuracy_delta``'s AUC delta on
    eval batches, and the logit difference of the towers' kernels stored
    in bf16."""
    from deeprec_tpu_torch.data.criteo import (CRITEO_HASH_BUCKETS,
                                               SyntheticCriteo)
    from deeprec_tpu_torch.feature_column.feature_column import batch_to
    from deeprec_tpu_torch.tools import low_precision as lp
    from deeprec_tpu_torch.train import loop as trainlib
    from deeprec_tpu_torch.train.metrics import batch_auc
    apply_fn = parts["apply_fn"]
    qvalues, sizes, steps = {}, [], []
    for tname, st in serving._ts.ev.items():
        qv = lp.quantize_ev_state(st).values
        qvalues[id(st.values)] = qv
        steps.append(_check_quantized(st.values, qv))
        f32 = st.values.numel() * st.values.element_size()
        sizes.append(f"{st.values.shape[1]} wide: int8 "
                     f"{qv.nbytes()} B against f32 {f32} B")

    def quantized_predict(b):
        with quantized_reads(qvalues):
            return serving.predict(b)
    data = SyntheticCriteo(batch_size=BATCH, vocab=CRITEO_HASH_BUCKETS,
                           seed=0)
    batches = [group.pack_batch_np(data.next_batch_np(wide=False), "cpu")
               for _ in range(LP_EVAL_BATCHES)]

    def metric(y, p):
        return float(batch_auc(torch.from_numpy(p), torch.from_numpy(y)))

    t0 = time.perf_counter()
    acc = lp.accuracy_delta(
        serving.predict,
        quantized_predict,
        batches, metric)
    lp_s = time.perf_counter() - t0
    b0 = batch_to(batches[0], serving._device)
    embs = trainlib.eval_embeddings(group, serving._ts, b0)
    params = serving._ts.params
    # The towers' kernels in bf16 storage; the head reads float32 (its
    # input is cast to float32) and keeps its own.
    towers = lp.to_bf16({k: v for k, v in params.items()
                         if k.startswith("deep.")})
    with torch.no_grad():
        full = apply_fn(params, embs, b0)
        half = apply_fn({**params, **towers}, embs, b0)
    q_diff = float((quantized_predict(b0) - full).abs().max())
    bf_diff = float((half.float() - full).abs().max())
    if not (np.isfinite(acc["delta"]) and q_diff <= LP_LOGIT_ATOL
            and np.isfinite(bf_diff)):
        raise AssertionError(f"26 (e): {acc}, int8 logit diff {q_diff} "
                             f"(bound {LP_LOGIT_ATOL}), bf16 {bf_diff}")
    log(f"phase 26 (e) low precision: {'; '.join(sizes)}; dequantized "
        f"values within {max(steps):.4g} of a step of the f32 ones "
        f"(bound {LP_HALF_STEP}); accuracy_delta "
        f"(AUC) over {LP_EVAL_BATCHES} x {BATCH} rows {acc} ({lp_s:.3f} s); "
        f"int8 tables' max abs logit diff {q_diff:.3g}; bf16 tower "
        f"kernels' {bf_diff:.3g}")


def phase_serving_rest(ckpt_dir: str, raw, logits, gather_err: float,
                       device="cuda") -> list:
    """Phase 26 (t): the rest of serving on the headline checkpoint of
    phase 4; see the module's docstring. Returns the K1 and P1 ``find``
    records of the ``serving_kserve``, ``serving_abi`` and
    ``serving_mesh`` paths."""
    from deeprec_tpu_torch.serving.processor import ServingModel
    t_phase = time.perf_counter()
    parts = _serve_parts(device)
    group = parts["group"]
    serving = ServingModel(group, parts["apply_fn"], parts["ts_template"],
                           ckpt_dir)
    serving.full_update()
    probs = torch.sigmoid(logits.double()).cpu().numpy()
    records = _serve_kserve(serving, group, raw, gather_err)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        records += _serve_abi(serving, parts, raw, probs, ckpt_dir, tmp,
                              gather_err)
        records += _serve_mesh(raw, logits, ckpt_dir, tmp, device)
    _serve_low_precision(serving, group, parts)
    _serve_remote(serving, group, parts, raw)
    log(f"phase 26 (t): the rest of serving in "
        f"{time.perf_counter() - t_phase:.3f} s")
    return records


# -- phase 27 (u): online input and the captured epoch on a mesh -------------

def _kafka_parse(group, dev, times: dict):
    """The online run's ``parse``: the port's native parser on the
    polled lines and ``batch_np_dict`` (no ``C*_wide`` columns, as the
    headline), then the pack onto the step's device; each part's host
    ms appended to ``times["parse"]`` and ``times["pack"]``."""
    from deeprec_tpu_torch import native
    from deeprec_tpu_torch.data import criteo

    def parse(msgs):
        t0 = time.perf_counter()
        rows, labels, dense, cats, _ = native.parse_criteo(
            b"\n".join(msgs) + b"\n", len(msgs))
        if rows != len(msgs):
            raise AssertionError(f"parsed {rows} of {len(msgs)} lines")
        raw = criteo.batch_np_dict(labels, dense, cats, wide=False)
        t1 = time.perf_counter()
        batch = group.pack_batch_np(raw, dev)
        times["parse"].append((t1 - t0) * 1e3)
        times["pack"].append((time.perf_counter() - t1) * 1e3)
        return batch
    return parse


def _train_stream(tr, ts, batches, label: str, overflow=None):
    """``ts`` trained over ``batches`` (an iterable): (state, losses,
    host ms of each ``next()``, ms of each step between CUDA events,
    the batches). A step's ``n_overflow`` above 0 raises, unless
    ``overflow`` (a list) is given: each step's count is appended to it
    instead."""
    losses, over, host_ms, events, seen = [], [], [], [], []
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        b = next(it, None)
        if b is None:
            break
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        ts, m = tr.step(ts, b)
        ev[1].record()
        events.append(ev)
        losses.append(m["loss"])
        over.append(m["n_overflow"])
        seen.append(b)
    torch.cuda.synchronize()
    counts = [int(x) for x in over]
    if overflow is not None:
        overflow.extend(counts)
    elif any(counts):
        raise AssertionError(f"phase {label}: n_overflow {counts}")
    return (ts, torch.stack(losses), host_ms,
            [s.elapsed_time(e) for s, e in events], seen)


def _tsv_into_topic(broker, path: str, topic: str, n_batches: int, data,
                    label: str):
    """``n_batches`` x ``BATCH`` TSV lines of ``data`` written to ``path``
    (``bench.write_tsv``) and produced into partition 0 of ``topic`` on
    ``broker``, one produce a batch."""
    from deeprec_tpu_torch import bench
    from deeprec_tpu_torch.data import kafka_protocol

    t0 = time.perf_counter()
    bench.write_tsv(path, n_batches * BATCH, data)
    with open(path, "rb") as f:
        lines = f.read().splitlines()
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prod = kafka_protocol.KafkaProtocolClient(broker.host, broker.port)
    for i in range(0, len(lines), BATCH):
        prod.produce(topic, 0, [(None, ln) for ln in lines[i:i + BATCH]])
    prod.close()
    log(f"phase {label}: {n_batches * BATCH} TSV lines "
        f"({os.path.getsize(path)} bytes) written in {write_s:.3f} s and "
        f"produced into topic {topic} of the port's MiniKafkaBroker "
        f"(loopback, one partition) in {time.perf_counter() - t0:.3f} s")


def _online_kafka(tmp: str, gather_err: float, apply_err: float) -> list:
    """27 (a): the headline trained from Kafka at full width; see the
    module's docstring. Returns the ``online_kafka`` records."""
    from deeprec_tpu_torch import bench
    from deeprec_tpu_torch.data import criteo, kafka, kafka_protocol
    from deeprec_tpu_torch.train import loop

    label = "27 (u) (a)"
    path = os.path.join(tmp, "criteo.tsv")
    broker = kafka_protocol.MiniKafkaBroker(num_partitions=1)
    try:
        _tsv_into_topic(broker, path, KAFKA_TOPIC, KAFKA_BATCHES,
                        criteo.SyntheticCriteo(
                            BATCH, vocab=criteo.CRITEO_HASH_BUCKETS,
                            seed=0), label)
        tr = bench.build_wdl(device="cuda")
        dev = tr.device
        start = loop.clone_state(tr.ts)

        def from_file(path):
            for raw in criteo.criteo_file_batches(path, BATCH, as_numpy=True,
                                                  wide=False):
                yield tr.group.pack_batch_np(raw, dev)

        want_ts, want, file_host, _, _ = _train_stream(
            tr, loop.clone_state(start), from_file(path), label)

        def dataset(max_batches, times, state=None, topic=KAFKA_TOPIC):
            ds = kafka.KafkaDataset(
                [topic], "chip_smoke", broker.bootstrap,
                batch_size=BATCH, parse=_kafka_parse(tr.group, dev, times),
                poll_timeout=KAFKA_POLL_S, max_batches=max_batches)
            if state is not None:
                ds.restore_state(state)
            return ds

        times = {"parse": [], "pack": []}
        ds = dataset(KAFKA_BATCHES, times)
        ts = loop.clone_state(start)
        torch.cuda.synchronize()
        _zoo_counts(reset=True)               # the main path starts here
        t0 = time.perf_counter()
        ts, got, host_ms, step_ms, seen = _train_stream(tr, ts, ds, label)
        run_s = time.perf_counter() - t0
        launches = _zoo_counts()              # the main path ends here
        ds.close()
        missing = [k for k in ("gather_rows", "adagrad_apply_rows",
                               "hash_probe_insert", "init_fresh_rows")
                   if launches[k] < 1]
        if missing:
            raise AssertionError(f"phase {label}: no launch of {missing} "
                                 f"on the Kafka-fed path ({launches})")
        if len(seen) != KAFKA_BATCHES or not torch.equal(got, want):
            raise AssertionError(f"phase {label}: Kafka losses "
                                 f"{got.tolist()} != file {want.tolist()}")
        n = _states_equal(ts, want_ts, label, "the Kafka-fed and the "
                          "file-fed tables")
        first = seen[0]
        del ts, seen
        log(f"phase {label}: the headline trained on {KAFKA_BATCHES} "
            f"batches from KafkaDataset equals the same lines through "
            f"criteo_file_batches bit for bit (losses "
            f"{[round(x, 6) for x in got.tolist()]}, {n} state tensors), "
            f"n_overflow 0; launches {launches}; {run_s:.3f} s in all")
        log(f"phase {label}: host ms a batch of poll + parse + pack "
            f"{[round(x, 1) for x in host_ms]} (native parse and "
            f"batch_np_dict {[round(x, 1) for x in times['parse']]}, pack "
            f"onto the card {[round(x, 1) for x in times['pack']]}); the "
            f"step's ms between CUDA events {[round(x, 3) for x in step_ms]}"
            f"; the file reader's host ms a batch "
            f"{[round(x, 1) for x in file_host]}")

        times = {"parse": [], "pack": []}
        ts = loop.clone_state(start)
        ds = dataset(KAFKA_STOP, times)
        ts, part1, _, _, _ = _train_stream(tr, ts, ds, label)
        state = ds.state()
        ds.close()
        if state != {f"{KAFKA_TOPIC}:0": KAFKA_STOP * BATCH}:
            raise AssertionError(f"phase {label}: state() {state} after "
                                 f"{KAFKA_STOP} batches")
        ds = dataset(KAFKA_BATCHES - KAFKA_STOP, times, state)
        ts, part2, _, _, _ = _train_stream(tr, ts, ds, label)
        ds.close()
        resumed = torch.cat([part1, part2])
        if not torch.equal(resumed, want):
            raise AssertionError(f"phase {label}: resumed losses "
                                 f"{resumed.tolist()} != {want.tolist()}")
        _states_equal(ts, want_ts, label, "the resumed run's and the "
                      "file-fed tables")
        log(f"phase {label}: stopped after batch {KAFKA_STOP} (state() "
            f"{state}), a new KafkaDataset restore_state()d and run to "
            f"{KAFKA_BATCHES}: losses and tables bit-equal to the run "
            f"without the stop")
        del ts, want_ts

        # The e2e row's stream: both runs drop the same ids against the
        # unique budgets, so n_overflow is held equal, not at 0.
        e2e_path = os.path.join(tmp, "criteo_e2e.tsv")
        _tsv_into_topic(broker, e2e_path, KAFKA_E2E_TOPIC, KAFKA_E2E_BATCHES,
                        criteo.SyntheticCriteo(BATCH, vocab=200_000, seed=7),
                        label)
        file_over, kafka_over = [], []
        want_ts, want, _, _, _ = _train_stream(
            tr, loop.clone_state(start), from_file(e2e_path), label,
            file_over)
        ds = dataset(KAFKA_E2E_BATCHES, {"parse": [], "pack": []},
                     topic=KAFKA_E2E_TOPIC)
        ts, got, _, _, seen = _train_stream(tr, loop.clone_state(start), ds,
                                            label, kafka_over)
        ds.close()
        if (len(seen) != KAFKA_E2E_BATCHES or not torch.equal(got, want)
                or kafka_over != file_over):
            raise AssertionError(
                f"phase {label}: e2e stream from Kafka: losses "
                f"{got.tolist()}, n_overflow {kafka_over} != file "
                f"{want.tolist()}, {file_over}")
        n = _states_equal(ts, want_ts, label, "the Kafka-fed and the "
                          "file-fed tables on the e2e stream")
        del ts, want_ts, seen
        log(f"phase {label}: the e2e row's stream (SyntheticCriteo("
            f"vocab=200_000, seed=7)), {KAFKA_E2E_BATCHES} batches from "
            f"KafkaDataset equal the same lines through criteo_file_batches"
            f" bit for bit (losses {[round(x, 6) for x in got.tolist()]}, "
            f"{n} state tensors); n_overflow {kafka_over} on both")
    finally:
        broker.shutdown()
    # The kernels on the operands of the stream's first step: its first
    # batch on the state the runs started from (every key new).
    tr.ts = start
    fetch, applies, probes, draws = _compare_step_kernels(
        tr, "adagrad", f"{label} first Kafka batch", first)
    del tr, start, first
    return _path_records("online_kafka", launches, fetch, applies,
                         gather_err, apply_err, probes=probes, draws=draws)


def _mesh_epoch_run(mesh) -> dict:
    """27 (b) and (c) on one NCCL rank: the sharded headline by
    ``make_epoch_step(mesh=)`` against ``make_train_step(mesh=)`` over
    the same pool from the same state, the kernels on the epoch's first
    step, then ``tools/scaling_model_torch.anchor_run``."""
    from deeprec_tpu_torch import bench
    from deeprec_tpu_torch.train import loop
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import scaling_model_torch

    label = f"27 (u) (b) rank {mesh.rank} of {mesh.size}, {mesh.backend}"
    E, K = MESH_EPOCH_EPOCHS, MESH_EPOCH_POOL
    tr = bench.build_wdl(device=mesh.device, mesh=mesh)
    pool = [tr.next_batch() for _ in range(K)]
    start = loop.clone_state(tr.ts)
    stepped = loop.clone_state(tr.ts)
    want, ms, over = [], [], []
    for i in range(E * K):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stepped, m = tr.step(stepped, pool[i % K])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        want.append(m["loss"])
        over.append(int(m["n_overflow"]))
    want = torch.stack(want)
    if any(over):
        raise AssertionError(f"phase {label}: n_overflow {over}")
    epoch = loop.make_epoch_step(tr.group, tr.apply_fn, tr.loss_fn,
                                 tr.sparse_opt, tr.dense_opt, n_epochs=E,
                                 mesh=mesh)
    stacked = loop.stack_batches(pool)
    mesh.trace = []
    torch.cuda.synchronize()
    _zoo_counts(reset=True)                   # the main path starts here
    t0 = time.perf_counter()
    tr.ts, losses = epoch(tr.ts, stacked)
    launches = _zoo_counts()                  # the main path ends here
    replay_ms = epoch.replay_ms()
    call_s = time.perf_counter() - t0
    trace, mesh.trace = mesh.trace, None
    run = epoch.last_run
    missing = [k for k in ("gather_rows", "adagrad_apply_rows",
                           "hash_probe_insert", "init_fresh_rows")
               if launches[k] < 1]
    if missing:
        raise AssertionError(f"phase {label}: no launch of {missing} in "
                             f"the captured mesh epoch ({launches})")
    if not (run["captured"] and run["replays"] == E * K - 1
            and run["steps"] == E * K):
        raise AssertionError(f"phase {label}: last_run {run}")
    if tuple(losses.shape) != (E, K) or not torch.equal(losses.reshape(-1),
                                                        want):
        raise AssertionError(f"phase {label}: captured losses "
                             f"{losses.tolist()} != stepped {want.tolist()}")
    n = _states_equal(tr.ts, stepped, label,
                      "the captured mesh epoch and the stepped mesh loop")
    if tr.ts.step != stepped.step:
        raise AssertionError(f"phase {label}: steps {tr.ts.step} vs "
                             f"{stepped.step}")
    captured = collections.Counter(r["kind"] for r in trace
                                   if r.get("captured"))
    eager0 = collections.Counter(r["kind"] for r in trace
                                 if not r.get("captured"))
    if captured != eager0 or captured["all_to_all"] < 1:
        raise AssertionError(f"phase {label}: the capture holds "
                             f"{dict(captured)}, step 0 ran {dict(eager0)}")
    cap_bytes = collections.Counter()
    for r in trace:
        if r.get("captured"):
            cap_bytes[r["kind"]] += r["bytes"]
    out = {"losses": losses.reshape(-1).tolist(), "state_tensors": n,
           "launches": launches, "replays": run["replays"],
           "replay_ms": replay_ms / run["replays"],
           "enqueue_ms": run["enqueue_s"] / run["replays"] * 1e3,
           "stepped_ms": ms, "call_s": call_s,
           "captured": dict(captured), "captured_bytes": dict(cap_bytes)}
    del stepped, stacked
    # The kernels on the operands of the epoch's first step: the pool's
    # first batch on the state the epoch started from (every key new).
    tr.ts = start
    fetch, applies, probes, draws = _compare_step_kernels(
        tr, "adagrad", f"{label} first pool batch", pool[0])
    out["kernels"] = {"fetch": fetch, "applies": applies, "probes": probes,
                      "draws": draws}
    del tr, start, pool
    gc.collect()
    torch.cuda.empty_cache()
    out["anchor"] = scaling_model_torch.anchor_run(mesh)
    return out


def _mesh_epoch_rank(rank, world, tmp, card, draws):
    """A spawned rank of 27 (b): joins an NCCL group of ``world`` ranks
    (a ``FileStore`` under ``tmp``), runs :func:`_mesh_epoch_run` and
    writes its results to ``tmp/epoch-r<rank>.json``."""
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from deeprec_tpu_torch.parallel import mesh as meshlib
    from deeprec_tpu_torch.parallel import multihost
    CARD.update(card)
    DRAW_INSTRUCTIONS.update(draws)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(
        backend="nccl", rank=rank, world_size=world, device="cuda",
        init_method="file://" + os.path.join(tmp, "store-epoch"))
    try:
        out = _mesh_epoch_run(meshlib.data_mesh(world))
        with open(os.path.join(tmp, f"epoch-r{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def phase_input_and_mesh_epoch(tmp: str, gather_err: float,
                               apply_err: float) -> list:
    """Phase 27 (u): online learning from Kafka, the captured epoch on an
    NCCL rank and the exchange byte model's anchor; see the module's
    docstring. Returns the ``online_kafka`` and ``sharded_epoch``
    records."""
    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    records = _online_kafka(tmp, gather_err, apply_err)
    _release()
    t0 = time.perf_counter()
    mp.spawn(_mesh_epoch_rank, nprocs=1, join=True,
             args=(1, tmp, dict(CARD), dict(DRAW_INSTRUCTIONS)))
    with open(os.path.join(tmp, "epoch-r0.json")) as f:
        res = json.load(f)
    label = "27 (u) (b)"
    log(f"phase {label}: one NCCL rank (S = 1), the sharded headline by "
        f"make_epoch_step(mesh=), {MESH_EPOCH_EPOCHS} x {MESH_EPOCH_POOL} "
        f"steps of B={BATCH}: equal to make_train_step(mesh=) stepped over "
        f"the same pool bit for bit (losses "
        f"{[round(x, 6) for x in res['losses']]}, {res['state_tensors']} "
        f"state tensors); captured, {res['replays']} replays, 0 host syncs "
        f"between the first and the last (set_sync_debug_mode('error')); "
        f"the capture holds {res['captured']} (bytes "
        f"{res['captured_bytes']}); device ms a replay "
        f"{res['replay_ms']:.3f} (CUDA events, back to back), host "
        f"enqueue {res['enqueue_ms']:.4f} ms a replay; the stepped mesh "
        f"loop's median synchronized step "
        f"{float(np.median(res['stepped_ms'])):.3f} ms "
        f"{[round(x, 3) for x in res['stepped_ms']]}; the whole call "
        f"{res['call_s']:.3f} s; launches (step 0 and the capture) "
        f"{res['launches']}; the rank's process in "
        f"{time.perf_counter() - t0:.3f} s")
    a = res["anchor"]
    log(f"phase 27 (u) (c): tools/scaling_model_torch anchor at S = "
        f"{a['shards']}: the sharded step's ms between CUDA events "
        f"{[round(x, 3) for x in a['sharded_step_ms']]}, the unsharded "
        f"step's {[round(x, 3) for x in a['unsharded_step_ms']]}; bytes a "
        f"step traced {a['traced_bytes']}, the model's {a['model_bytes']}:"
        f" all-to-all and all-reduce equal")
    ker = res["kernels"]
    sharded = _path_records("sharded_epoch", res["launches"], ker["fetch"],
                            ker["applies"], gather_err, apply_err,
                            probes=ker["probes"], draws=ker["draws"])
    for rec in sharded:
        rec["graph_replays"] = res["replays"]
    log(f"phase 27 (u): online input and the captured mesh epoch in "
        f"{time.perf_counter() - t_phase:.3f} s")
    return records + sharded


def _occ_case(B, vocab, dim, seed):
    """One table's combine at a cell's shape: rows [U + 1, dim] (U = B
    x columns, as the lookup makes it), its inverse over Zipf(1.2) ids
    folded by each column's ``vocab``, all real, and the columns' output
    gradients (float32, on the card)."""
    rng = np.random.default_rng(seed)
    n_cols = len(vocab)
    ids = (rng.zipf(1.2, (B, n_cols)) - 1) % np.asarray(vocab)
    ids = ids.astype(np.int64) + (np.arange(n_cols, dtype=np.int64) << 40)
    _, inv = np.unique(ids.reshape(-1), return_inverse=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    U = B * n_cols
    return (torch.randn(U + 1, dim, generator=gen, device=dev),
            torch.from_numpy(inv.reshape(B, n_cols)).to(dev),
            torch.ones(B, n_cols, dtype=torch.bool, device=dev),
            [torch.randn(B, dim, generator=gen, device=dev)
             for _ in range(n_cols)])


def compare_occ(label, rows, inv, mask, combiner, gouts) -> dict:
    """The combine of one table (width-1 bags) by the kernels and by the
    plain version: equal outputs and row gradients; times and bounds."""
    from deeprec_tpu_torch.ops.kernels import occ_combine as occ
    from deeprec_tpu_torch.utils import trace
    B, n_cols = inv.shape
    dim = rows.shape[1]
    cols = [occ.Column(1, False, combiner)] * n_cols
    none = [None] * n_cols

    def fwd(fn, r, **kw):
        return fn(r, inv, mask, cols, none, **kw)

    def step(fn, **kw):
        r = rows.detach().requires_grad_()
        torch.autograd.grad(fwd(fn, r, **kw), [r], gouts)

    def run(fn):
        r = rows.detach().requires_grad_()
        out = fwd(fn, r)
        (g,) = torch.autograd.grad(out, [r], gouts)
        return [o.detach() for o in out], g

    got, want = run(occ.occ_combine), run(occ.occ_combine_reference)
    torch.cuda.synchronize()
    if not (all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
            and torch.equal(got[1], want[1])):
        raise AssertionError(f"occ_combine {label}: differs from its plain "
                             f"version")
    counts = torch.bincount(inv.reshape(-1), minlength=rows.shape[0])
    _, counters = trace.counted(lambda: step(occ.occ_combine, table="t"))
    split = int(counters["t/grad_split_rows"])
    if split != int((counts > occ.CHUNK).sum()):
        raise AssertionError(f"occ_combine {label}: {split} rows split off, "
                             f"{int((counts > occ.CHUNK).sum())} longer than "
                             f"a chunk")
    n, distinct = inv.numel(), int((counts > 0).sum())
    fwd_bytes = (distinct + B * n_cols) * dim * 4 + 17 * n
    bwd_bytes = (B * n_cols + rows.shape[0]) * dim * 4 + 16 * n
    r0 = rows.detach()
    ms_f = median_ms(lambda: fwd(occ.occ_combine, r0))
    ms_s = median_ms(lambda: step(occ.occ_combine))
    plain_f = median_ms(lambda: fwd(occ.occ_combine_reference, r0))
    plain_s = median_ms(lambda: step(occ.occ_combine_reference))
    lib_f = event_ms(lambda: fwd(occ.occ_combine_reference, r0))
    lib_s = event_ms(lambda: step(occ.occ_combine_reference))
    recs = {}
    for d, ms, plain, lib, nbytes in (
            ("forward", ms_f, plain_f, lib_f, fwd_bytes),
            ("backward", ms_s - ms_f, plain_s - plain_f, lib_s - lib_f,
             bwd_bytes)):
        recs[d] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                   "bound_ms": bound_ms(nbytes), "max_abs_err": 0.0}
        log(f"phase 28 occ_combine {label} {d}: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, autograd event-fenced {lib:.4f} ms, bound "
            f"{recs[d]['bound_ms']:.4f} ms ({_pct(recs[d])})")
    log(f"phase 28 occ_combine {label}: [{rows.shape[0]}, {dim}] rows, B = "
        f"{B}, {n_cols} columns ({combiner}), {distinct} rows read, "
        f"{rows.shape[0] - distinct} zero; {split} split off (longest "
        f"{int(counts.max())} occurrences); equal to the plain version")
    return recs


def phase_occ_combine() -> list:
    """Phase 28: the combine and its backward at the cells' shapes."""
    from deeprec_tpu_torch.ops.kernels import occ_combine as occ
    cfg_dir = os.path.join(ROOT, "benchmark", "configs")
    with open(os.path.join(cfg_dir, "dlrm_mlperf.json")) as f:
        dlrm = json.load(f)
    with open(os.path.join(cfg_dir, "wdl_criteo.json")) as f:
        wdl = json.load(f)
    by_dim = collections.defaultdict(list)
    for b, d in zip(wdl["hash_bucket_sizes"], wdl["embedding_dims"]):
        by_dim[d + 1].append(b)
    cases = [("dlrm", dlrm["batch_size"], dlrm["num_embeddings_per_feature"],
              dlrm["arch_sparse_feature_size"], "sum")]
    cases += [(f"wdl{d}", wdl["batch_size"], by_dim[d], d, "mean")
              for d in sorted(by_dim, reverse=True)]
    out = []
    for i, (label, B, vocab, dim, comb) in enumerate(cases):
        rows, inv, mask, gouts = _occ_case(B, vocab, dim, 280 + i)
        recs = compare_occ(label, rows, inv, mask, comb, gouts)
        for d, rec in recs.items():
            out.append(_record(f"occ_combine_{d}[{label}]",
                               "deeprec_tpu_torch/csrc/occ_combine.cu",
                               "none (XLA's gather and autodiff scatter-add)",
                               None, 0.0, rec, "occ_combine"))
        del rows, inv, mask, gouts
    # One row of 20,000 occurrences among uniform others.
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(28)
    inv = torch.randint(0, 5000, (1000, 64), generator=gen, device=dev)
    inv.view(-1)[torch.randperm(64000, generator=gen, device=dev)[:20000]] = 5
    rows = torch.randn(5001, 128, generator=gen, device=dev)
    mask = torch.ones(1000, 64, dtype=torch.bool, device=dev)
    gouts = [torch.randn(1000, 128, generator=gen, device=dev)
             for _ in range(64)]
    compare_occ("hot row", rows, inv, mask, "sum", gouts)
    torch.cuda.empty_cache()
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _release():
    """Return the memory of dropped trainers to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def main():
    kind = phase_device()
    sys.path.insert(0, ROOT)
    phase_build()
    gather_err = phase_kernel()
    apply_err = phase_apply_kernels()
    occ_records = phase_occ_combine()
    full_table = phase_probe()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as ckpt_dir:
        parts, raw = phase_state(ckpt_dir)
        logits, serve_launches, finds = phase_serving(parts, raw, ckpt_dir)
        del parts
        torch.cuda.empty_cache()
        phase_worker(raw, logits, ckpt_dir)
        serve_records = phase_serving_rest(ckpt_dir, raw, logits,
                                           gather_err)
    _release()
    tr, _, k2, k1, launches, p1, i1 = phase_train("adagrad", "8 (b)", 30,
                                                  30)
    for r in occ_records:                     # launched by the headline path
        r["launches"] = launches["occ_combine"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
        phase_checkpoint(tr, d)
    del tr
    _release()
    tr, _, k3, _, adam_launches, _, _ = phase_train("adam", "10 (c)",
                                                 *ADAM_STEPS)
    del tr
    _release()
    phase_small()
    tr, _, s2, s1, s_launches, _, _ = phase_train("adagrad", "12 (f)", 30,
                                                  30,
                                               static_buckets=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_static_") as d:
        phase_static_serve_and_checkpoint(tr, d)
    del tr
    _release()
    tr, _, d2, d1, d_launches, dp, di = phase_train(
        "adagrad", "13 (g)", *DIM16_STEPS, reference_shapes=False)
    del tr
    _release()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_e2e_") as d:
        e1, e2, e_launches, ep, ei = phase_e2e(d)
    _release()
    phase_optimizers()
    phase_fused_and_repeat()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ev_") as d:
        v_launches, v1, v2, vp, vi, vf = phase_ev_cbf(d)
    _release()
    epoch_records = phase_epoch(gather_err, apply_err)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as d:
        zoo_records = phase_zoo(d, gather_err, apply_err)
    _release()
    zoo_epoch_launches = phase_zoo_epoch()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as d:
        bench_records = phase_tools(d)
    _release()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as d:
        sh_launches, sh = phase_sharded(d)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_variants_") as d:
        variant_records = phase_variants(d, gather_err, apply_err)
    _release()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tiered_") as d:
        tier_records = phase_tiered(d, gather_err, apply_err)
    _release()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_input_") as d:
        input_records = phase_input_and_mesh_epoch(d, gather_err, apply_err)
    _release()
    full_table["path"] = "full 65-wide table"
    records = (
        _path_records("headline", launches, k1, k2, gather_err, apply_err,
                      probes=p1, draws=i1)
        + _path_records("headline", adam_launches, k1, k3, gather_err,
                        apply_err, kind="adam")[1:]
        + [_probe_record("serving", serve_launches, finds, kind="find")]
        + serve_records
        + _path_records("static_bucket", s_launches, s1, s2, gather_err,
                        apply_err)
        + _path_records("dim16", d_launches, d1, d2, gather_err, apply_err,
                        probes=dp, draws=di)
        + _path_records("e2e", e_launches, e1, e2, gather_err, apply_err,
                        probes=ep, draws=ei)
        + _path_records("ev_cbf", v_launches, v1, v2, gather_err, apply_err,
                        probes=vp, draws=vi)
        + [_probe_record("ev_cbf", v_launches, vf, kind="find")]
        + epoch_records + zoo_records
        + _zoo_epoch_records(zoo_epoch_launches, zoo_records)
        + bench_records
        + _path_records("sharded", sh_launches, sh["fetch"], sh["applies"],
                        gather_err, apply_err, probes=sh["probes"],
                        draws=sh["draws"])
        + variant_records + tier_records + input_records + occ_records)
    log(f"P1 on the full 65-wide table (phase 15): kernel "
        f"{full_table['ms']:.4f} ms (fast round {full_table['fast_ms']:.4f},"
        f" straggler kernel {full_table['straggler_ms']:.4f}), plain "
        f"{full_table['plain_ms']:.4f} ms, bound {full_table['bound_ms']:.4f}"
        f" ms; the kernel ran {full_table['rounds']} rounds, the plain "
        f"version {full_table['plain_rounds']} (first all-dead round "
        f"{full_table['first_dead_round']})")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
