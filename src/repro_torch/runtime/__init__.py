from repro_torch.runtime.fault import (FaultConfig, StragglerMonitor,
                                       run_with_restarts)
from repro_torch.runtime.compress import (dequantize_int8,
                                          make_int8_compressor,
                                          quantize_int8)

__all__ = ["FaultConfig", "StragglerMonitor", "run_with_restarts",
           "make_int8_compressor", "quantize_int8", "dequantize_int8"]
