from repro_torch.core.compression.base import (  # noqa: F401
    Compressed,
    compress_p,
    decompress_p,
    get_compressor,
    register,
    runtime_knob_values,
)
from repro_torch.core.compression import kernels_backed, quantization  # noqa: F401  (register)
