from repro_torch.core.policies.base import Policy, StopReason
from repro_torch.core.policies.sched_coop import SchedCoop
from repro_torch.core.policies.sched_fair import SchedFair
from repro_torch.core.policies.sched_rr import SchedRR

__all__ = ["Policy", "StopReason", "SchedCoop", "SchedFair", "SchedRR"]
