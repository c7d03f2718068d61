"""Head process entry: `python -m ray_tpu_torch.cluster.head_main --port 0`.

Prints "ADDRESS <host:port>" on stdout once serving (parent parses it).
"""

from __future__ import annotations

import argparse
import sys
import time

from ray_tpu_torch.cluster.head import HeadServer


def main() -> None:
    import faulthandler
    import signal

    from ray_tpu_torch.core.process_util import bind_to_parent

    bind_to_parent()  # PDEATHSIG armed in the CHILD (no preexec_fn fork)

    faulthandler.register(signal.SIGUSR1)
    from ray_tpu_torch.util import flight_recorder as _flight

    _flight.set_role("head")
    _flight.install_signal_handler()  # SIGUSR2 = dump the event ring

    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--persist", default=None,
                   help="sqlite path for durable head tables; a restarted "
                        "head (same --port + --persist) resumes from it")
    args = p.parse_args()
    head = HeadServer(args.host, args.port, persist_path=args.persist)
    print(f"ADDRESS {head.address}", flush=True)

    def _graceful_term(signum, frame):
        # Rolling-upgrade handover (or supervisor teardown): stop the
        # server FIRST — that severs every parked peer connection so
        # heartbeats fail over to the successor immediately — then close
        # the durable store cleanly and release the port by exiting.
        print("RTPU_HEAD: SIGTERM — releasing port", flush=True)
        import os as _os

        try:
            head.shutdown()
        finally:
            _os._exit(0)

    signal.signal(signal.SIGTERM, _graceful_term)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        head.shutdown()


if __name__ == "__main__":
    main()
