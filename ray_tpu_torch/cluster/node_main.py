"""Node-manager process entry:
`python -m ray_tpu_torch.cluster.node_main --head-addr H --resources JSON`.

Prints "ADDRESS <host:port> NODE <node_id> STORE <name>" once serving.
"""

from __future__ import annotations

import argparse
import json
import time
import uuid

from ray_tpu_torch.cluster.node_manager import (NodeManager,
                                                store_segment_name)


def main() -> None:
    import faulthandler
    import signal

    from ray_tpu_torch.core.process_util import bind_to_parent

    bind_to_parent()  # PDEATHSIG armed in the CHILD (no preexec_fn fork)

    faulthandler.register(signal.SIGUSR1)
    from ray_tpu_torch.util import flight_recorder as _flight

    _flight.set_role("node")
    _flight.install_signal_handler()  # SIGUSR2 = dump the event ring

    p = argparse.ArgumentParser()
    p.add_argument("--head-addr", required=True)
    p.add_argument("--resources", default="{}")
    p.add_argument("--labels", default="{}")
    p.add_argument("--node-id", default=None)
    p.add_argument("--object-store-bytes", type=int, default=None)
    args = p.parse_args()

    from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
    from ray_tpu_torch.core.resources import detect_node_resources

    resources = json.loads(args.resources)
    if not resources:
        nr = detect_node_resources()
        resources = nr.total.to_dict()
        labels = dict(nr.labels)
    else:
        labels = {}
    labels.update(json.loads(args.labels))
    node_id = args.node_id or uuid.uuid4().hex
    store_bytes = args.object_store_bytes or cfg.object_store_memory_bytes
    try:
        nm = NodeManager(args.head_addr, node_id, resources, labels,
                         store_bytes)
    except BaseException:
        # The store may exist already (say the head was unreachable): a
        # node that never served must not leave its segment behind.
        from ray_tpu_torch.core.shm_store import unlink_segment

        unlink_segment(store_segment_name(node_id))
        raise
    print(f"ADDRESS {nm.address} NODE {node_id} STORE {nm.store_name}",
          flush=True)

    def _graceful_term(signum, frame):
        # The driver's shutdown: stop the workers and unlink the store's
        # segment, which a plain SIGTERM death would leave behind.
        import os as _os

        try:
            nm.shutdown()
        finally:
            _os._exit(0)

    signal.signal(signal.SIGTERM, _graceful_term)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        nm.shutdown()


if __name__ == "__main__":
    main()
