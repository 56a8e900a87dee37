from repro_torch.sched.dvfs import FrequencyActuator, SimActuator
from repro_torch.sched.power_sched import (IncrementalPacker, JobPlan,
                                     PowerAwareScheduler, RepackStats,
                                     ScheduleResult)
