import torch

from .metrics import (Metrics, ProfilerRange, SpanLog,  # noqa: F401
                      SpanRecord, StageClock, StageTimer, WorkerClock,
                      metrics, worker_clock)
from .logging import get_logger  # noqa: F401
from .profiling import (RecordsDropped, TraceRecords,  # noqa: F401
                        device_trace, measure_device_stages,
                        profile_complete, trace_records,
                        unmatched_launches)


def resolve_device(device) -> torch.device:
    """The torch device of a decoder or pipeline: a CUDA device without a
    card raises here, before any work (the port never falls back to the
    CPU; callers ask for it with device="cpu")."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    return dev


def device_key(device) -> str:
    """The string that keys a per-device cache: the device with its index,
    so a table uploaded for "cuda" (the current card) is never handed out
    on another card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)
