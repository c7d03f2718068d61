"""joblib parallel backend over cluster tasks
(``ray_tpu/util/joblib_backend.py``; the backend keeps its name,
``"ray_tpu"``, so code written for ``ray_tpu`` changes one import).

Parity target: the reference's joblib integration
(reference: python/ray/util/joblib/__init__.py register_ray +
ray_backend.py RayBackend): ``register_ray_tpu()`` then
``joblib.parallel_backend("ray_tpu")`` runs scikit-learn style
``Parallel(n_jobs=...)`` workloads as cluster tasks."""

from __future__ import annotations


def register_ray_tpu() -> None:
    from joblib import register_parallel_backend
    from joblib._parallel_backends import ParallelBackendBase

    import ray_tpu_torch

    class RayTpuBackend(ParallelBackendBase):
        supports_timeout = True
        uses_threads = False
        supports_sharedmem = False

        def configure(self, n_jobs=1, parallel=None, **kwargs):
            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init()
            self.parallel = parallel
            return self.effective_n_jobs(n_jobs)

        def effective_n_jobs(self, n_jobs):
            if n_jobs == -1:
                try:
                    return max(1, int(ray_tpu_torch.cluster_resources()
                                      .get("CPU", 1)))
                except Exception:
                    return 1
            return max(1, int(n_jobs or 1))

        def apply_async(self, func, callback=None):
            from ray_tpu_torch.util.multiprocessing import (_apply_one,
                                                      _run_chunk)

            # Shared module-level task (one export, not a fresh
            # RemoteFunction per call).
            ref = _run_chunk.remote(_apply_one, [(func, (), {})], False)

            class _Future:
                def get(self, timeout=None):
                    return ray_tpu_torch.get(ref, timeout=timeout)[0]

            fut = _Future()
            if callback is not None:
                import threading

                def _wait_cb():
                    try:
                        result = ray_tpu_torch.get(ref, timeout=None)[0]
                    except BaseException:  # noqa: BLE001
                        return
                    callback(result)

                threading.Thread(target=_wait_cb, daemon=True).start()
            return fut

        def abort_everything(self, ensure_ready=True):
            if ensure_ready:
                self.configure(n_jobs=self.parallel.n_jobs,
                               parallel=self.parallel)

    register_parallel_backend("ray_tpu", RayTpuBackend)
