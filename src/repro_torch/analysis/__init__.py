from repro_torch.analysis.hardware import (CHIP_MODELS, FREQ_SWEEP, V5E,
                                           ChipSpec)
