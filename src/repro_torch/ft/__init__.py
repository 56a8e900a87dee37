from repro_torch.ft.elastic import ElasticPlan, plan_new_mesh, rescale_batch
from repro_torch.ft.fleetwatch import FleetStragglerAdapter
from repro_torch.ft.heartbeat import PreemptionHandler, StragglerMonitor

__all__ = [
    "ElasticPlan", "plan_new_mesh", "rescale_batch",
    "FleetStragglerAdapter", "PreemptionHandler", "StragglerMonitor",
]
