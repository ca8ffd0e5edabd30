"""Quickstart: the USF scheduler in 60 lines.

Two co-located jobs on a 4-slot "node": a bursty latency-sensitive job and
a throughput job. SCHED_COOP multiplexes them at blocking points only —
no preemptions, FIFO fairness via the per-job quantum.

Run:  PYTHONPATH=src python examples/quickstart.py
"""

from repro_torch.core import simtask as st
from repro_torch.core.events import SimExecutor
from repro_torch.core.policies import SchedCoop, SchedFair
from repro_torch.core.task import Job
from repro_torch.core.topology import Topology


def workload(sim):
    """A throughput job (long uninterrupted compute) + a service job
    (short bursts separated by blocking waits)."""
    throughput = Job("throughput")
    service = Job("service")
    latencies = []

    def hog():
        for _ in range(4):
            yield st.compute(0.050)

    def burst(i):
        def gen():
            t0 = sim.now()
            yield st.compute(0.005)
            latencies.append(sim.now() - t0)

        return gen

    for _ in range(4):
        sim.spawn(throughput, hog)
    for i in range(16):
        sim.spawn(service, burst(i), at=0.010 * i)
    return latencies


def main():
    for policy in (SchedCoop(quantum=0.02), SchedFair(slice_s=0.003)):
        sim = SimExecutor(Topology(4, 1), policy)
        lat = workload(sim)
        stats = sim.run()
        print(f"{policy.name:12s} makespan={stats.makespan * 1e3:7.1f}ms "
              f"burst-latency-mean={sum(lat) / len(lat) * 1e3:6.1f}ms "
              f"preemptions={stats.preemptions} "
              f"migrations={stats.migrations}")


if __name__ == "__main__":
    main()
