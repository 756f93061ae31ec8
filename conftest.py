"""Dispatch order of the test files: the longest first.

``pytest -n N --dist loadfile`` hands whole files to the workers. By
default xdist queues them by how many tests they collect, the most
first, so a file of a few long tests (``tests/test_placement.py``: 5
tests, most of the run's length) starts late and its time adds to the
time it waited. Here the queue follows each file's measured seconds
instead, the longest first, so the long files start at once and the
short ones fill the other workers around them.

``FILE_SECONDS`` holds each file's seconds summed from the testcases of
a whole run's ``--junitxml`` (the Tier-1 command: six workers, 1,307 s
in all, ``tests/test_placement.py`` 1,234.7 s of it). A file missing
from the table is taken to last ``UNMEASURED_SECONDS``, the budget of a
new test file. Tests keep their order inside a file, and nothing is
skipped or deselected. This file imports neither JAX nor torch.
"""

import os

FILE_SECONDS = {
    "tests/test_placement.py": 1234.7,
    "tests/test_wdl_training.py": 720.6,
    "tests/test_sharded_embedding.py": 561.8,
    "tests/test_model_zoo.py": 560.4,
    "tests/test_train_features.py": 354.1,
    "tests/test_ev_behavior_matrix.py": 273.4,
    "tests/test_kafka.py": 211.3,
    "tests/test_occ_lookup.py": 138.4,
    "tests/test_multi_tier.py": 138.2,
    "tests/test_dyn_dim.py": 129.0,
    "tests/test_embedding_variable.py": 104.9,
    "tests/test_checkpoint.py": 92.3,
    "tests/test_tensible.py": 80.0,
    "tests/test_optimizer_matrix.py": 69.5,
    "tests/test_static_sharded.py": 68.4,
    "tests/test_processor_abi.py": 56.7,
    "tests/test_train_zoo_cli.py": 53.3,
    "tests/test_torch_ev_admission.py": 50.5,
    "tests/test_hash_table.py": 42.9,
    "tests/test_torch_train.py": 41.5,
    "tests/test_estimator.py": 41.4,
    "tests/test_torch_checkpoint.py": 38.0,
    "tests/test_fused_combine.py": 36.9,
    "tests/test_serving.py": 35.2,
    "tests/test_torch_hash_table.py": 34.4,
    "tests/test_torch_serving.py": 34.1,
    "tests/test_torch_ev_matrix.py": 33.6,
    "tests/test_ev_features.py": 31.6,
    "tests/test_torch_zoo_layers.py": 31.4,
    "tests/test_static_bucket.py": 29.8,
    "tests/test_torch_static_bucket.py": 29.3,
    "tests/test_torch_estimator.py": 28.5,
    "tests/test_torch_zoo.py": 26.0,
    "tests/test_torch_epoch.py": 25.9,
    "tests/test_serving_sdk.py": 25.5,
    "tests/test_coalesce.py": 24.8,
    "tests/test_twoprocess.py": 23.6,
    "tests/test_torch_variable.py": 23.1,
    "tests/test_adaptive_sharded.py": 23.1,
    "tests/test_torch_hash_probe.py": 20.3,
    "tests/test_ops_tools.py": 20.1,
    "tests/test_torch_optimizers.py": 19.9,
    "tests/test_kserve.py": 19.2,
    "tests/test_torch_wdl.py": 18.7,
    "tests/test_pallas_apply.py": 16.2,
    "tests/test_weighted_column.py": 13.7,
    "tests/test_adaptive_group.py": 13.1,
    "tests/test_torch_occ_lookup.py": 12.2,
    "tests/test_redis_store.py": 12.2,
    "tests/test_torch_fused_combine.py": 12.0,
    "tests/test_torch_sparse_apply.py": 8.8,
    "tests/test_torch_fused_ops.py": 8.0,
    "tests/test_multihost.py": 4.8,
    "tests/test_torch_keys.py": 3.7,
    "tests/test_torch_init_rows.py": 2.2,
    "tests/test_kafka_group.py": 2.1,
    "tests/test_torch_gather.py": 1.8,
    "tests/test_data_pipeline.py": 1.6,
    "tests/test_torch_input_pipeline.py": 1.3,
    "tests/test_native.py": 0.1,
}
UNMEASURED_SECONDS = 60.0


def pytest_configure(config):
    # Dispatch files in collection order (set below), not by test count.
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False


def _file_of(item):
    return os.path.relpath(str(item.path), str(item.config.rootpath))


def pytest_collection_modifyitems(session, config, items):
    first_seen = {}
    for i, item in enumerate(items):
        first_seen.setdefault(_file_of(item), i)

    def key(pair):
        i, item = pair
        f = _file_of(item)
        return (-FILE_SECONDS.get(f, UNMEASURED_SECONDS), first_seen[f], i)

    items[:] = [item for _, item in sorted(enumerate(items), key=key)]
