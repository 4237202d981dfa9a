"""Async-ish logging setup (reference: src/lancet/base/logging.h).

The reference uses an spdlog async logger with a 32k-entry queue and one
background sink thread. Python's logging is synchronous by default; we use a
QueueHandler + QueueListener pair to keep worker threads from blocking on
stderr I/O, matching the reference's design intent.
"""

from __future__ import annotations

import atexit
import logging
import logging.handlers
import queue
import sys

_LISTENER: logging.handlers.QueueListener | None = None
_CONFIGURED = False


def configure(verbose: bool = False) -> None:
    global _LISTENER, _CONFIGURED
    if _CONFIGURED:
        logging.getLogger("lancet2_tpu_torch").setLevel(
            logging.DEBUG if verbose else logging.INFO
        )
        return
    log_queue: queue.Queue = queue.Queue(32_768)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
            datefmt="%Y-%m-%d %H:%M:%S",
        )
    )
    _LISTENER = logging.handlers.QueueListener(log_queue, handler)
    _LISTENER.start()
    atexit.register(_LISTENER.stop)
    root = logging.getLogger("lancet2_tpu_torch")
    root.addHandler(logging.handlers.QueueHandler(log_queue))
    root.setLevel(logging.DEBUG if verbose else logging.INFO)
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"lancet2_tpu_torch.{name}")
