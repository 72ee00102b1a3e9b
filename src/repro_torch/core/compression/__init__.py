from repro_torch.core.compression.base import (  # noqa: F401
    Compressed,
    compress_p,
    decompress_p,
    get_compressor,
    register,
    runtime_knob_values,
)
from repro_torch.core.compression import (  # noqa: F401  (register)
    kernels_backed,
    policy,
    powersgd,
    quantization,
    sparsification,
)
