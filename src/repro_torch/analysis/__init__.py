from repro_torch.analysis.hardware import (CHIP_MODELS, FREQ_SWEEP, H100, V5E,
                                           ChipSpec, GpuSpec)
from repro_torch.analysis.cost import Cost, CostCounter
from repro_torch.analysis.roofline import (RooflineReport, build_report,
                                           model_flops)
