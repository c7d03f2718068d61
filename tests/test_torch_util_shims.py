"""The ``multiprocessing.Pool`` shim and the joblib backend of the port
(``ray_tpu_torch/util/multiprocessing.py``, ``joblib_backend.py``), as
``tests/test_util_shims.py`` holds ``ray_tpu``'s. The functions are
lambdas or nested, so the cluster ships them by value."""

import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def cluster():
    rt = ray_tpu_torch.init(num_cpus=4, object_store_memory=128 << 20)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()


def _fns():
    def sq(x):
        return x * x

    def addmul(a, b):
        return a * 10 + b

    return sq, addmul


def test_pool_map_variants(cluster):
    from ray_tpu_torch.util.multiprocessing import Pool

    sq, addmul = _fns()
    with Pool(processes=4) as p:
        assert p.map(sq, range(20)) == [i * i for i in range(20)]
        assert p.starmap(addmul, [(1, 2), (3, 4)]) == [12, 34]
        assert list(p.imap(sq, range(10), chunksize=3)) == [
            i * i for i in range(10)]
        assert sorted(p.imap_unordered(sq, range(10), chunksize=2)) == \
            sorted(i * i for i in range(10))
        assert p.apply_async(addmul, (5, 6)).get(timeout=60) == 56
        assert p.apply(sq, (9,)) == 81
    with pytest.raises(ValueError):
        p.map(sq, [1])  # closed


def test_pool_bounds_inflight_and_empty(cluster):
    import time

    from ray_tpu_torch.util.multiprocessing import Pool

    sq, _ = _fns()
    with Pool(processes=2) as p:
        r = p.map_async(sq, [])
        assert r.ready() and r.get(timeout=10) == []
        slow = p.apply_async(time.sleep, (1.5,))
        if not slow.ready():
            with pytest.raises(ValueError):
                slow.successful()
        slow.wait(timeout=30)
        res = p.map_async(sq, range(40), chunksize=1)
        res._pump(block=False)
        assert len(res._refs) <= 2
        assert res.get(timeout=120) == [i * i for i in range(40)]


def test_pool_error_is_sticky(cluster):
    """A failed chunk re-raises on every ``get`` (the stdlib contract)."""
    from ray_tpu_torch.exceptions import TaskError
    from ray_tpu_torch.util.multiprocessing import Pool

    def boom(x):
        raise KeyError(x)

    with Pool(processes=2) as p:
        r = p.map_async(boom, [1, 2], chunksize=1)
        for _ in range(2):
            with pytest.raises(TaskError):
                r.get(timeout=60)
        assert r.ready() and not r.successful()


def test_joblib_backend(cluster):
    joblib = pytest.importorskip("joblib")
    from ray_tpu_torch.util.joblib_backend import register_ray_tpu

    sq, _ = _fns()
    register_ray_tpu()
    with joblib.parallel_backend("ray_tpu", n_jobs=4):
        out = joblib.Parallel()(joblib.delayed(sq)(i) for i in range(12))
    assert out == [i * i for i in range(12)]
