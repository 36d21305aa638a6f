"""route.torch_device_ms: device time a step of every event that is
not one of the port's hand-written kernels (`crlot_tpu_torch/csrc`, named
below): the formulation's own PyTorch work (pads, cats, copies, divides,
fills, cuBLAS edge patches)."""

PORT_KERNELS = (
    "b6_sm90_kernel", "fq_row_scale_kernel", "fp32_window_kernel",
    "rt_fold_kernel", "rt_gemm_kernel", "ola_normalized_kernel",
    "axpy_kernel", "axpy_windowed_kernel", "normalize_kernel",
    "runs_kernel", "blocks_kernel", "windows_kernel",
)


def read(ctx):
    s = ctx["summary"]
    if s is None:
        return None
    total = sum(sec for name, sec in s["device_s_by_name"].items()
                if not any(k in name for k in PORT_KERNELS))
    return 1e3 * total / s["steps"]
