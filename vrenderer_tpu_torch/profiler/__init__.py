from vrenderer_tpu_torch.profiler.profiler import (  # noqa: F401
    REFERENCE_CPU_COUNTERS,
    REFERENCE_GPU_COUNTERS,
    FrameProfiler,
    PassTimer,
    active,
    counter,
    last_recorder,
    span,
    start_device_trace,
    stop_device_trace,
    sync_copy,
)
