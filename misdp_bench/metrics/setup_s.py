"""setup_s: seconds from process start to the window's first unit of work
(imports, the CUDA context, the kernels' build or load, the instance, the
solver's data, the warm-up unit)."""


def read(rec):
    return rec["setup_s"]
