from repro_torch.telemetry.kernel_stream import (Kernel, KernelStream,
                                                 build_stream)
from repro_torch.telemetry.power_model import TPUPowerModel
from repro_torch.telemetry.simulator import (SimTrace, TelemetryChunk,
                                             TraceMeta, simulate,
                                             stream_telemetry)
from repro_torch.telemetry.workloads import (fleet_job_mix, holdout_streams,
                                             novel_streams, reference_streams)
