"""Cluster node models.

The six machines reproduce Table 2 of the paper exactly (these numbers are
the published microbenchmark readings; we treat them as ground-truth specs
and let `simulate_microbench` re-observe them with noise).  The TPU fleet
models a heterogeneous accelerator pool for the ML-workload integration
(Lotaru-R), with per-chip roofline capabilities.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.extrapolation import NodeRoofline
from repro_torch.core.microbench import NodeSpec

# --- Table 2 (paper) -------------------------------------------------------
LOCAL = NodeSpec("local", cpu=458, mem=18700, io_read=437, io_write=415,
                 cores=8, power_watts=80, price_per_hour=0.0, net_gbps=1.0)
A1 = NodeSpec("A1", cpu=223, mem=11000, io_read=306, io_write=301,
              cores=8, power_watts=240, price_per_hour=0.28, net_gbps=1.0)
A2 = NodeSpec("A2", cpu=223, mem=11000, io_read=341, io_write=336,
              cores=8, power_watts=240, price_per_hour=0.28, net_gbps=1.0)
N1 = NodeSpec("N1", cpu=369, mem=13400, io_read=481, io_write=483,
              cores=8, power_watts=180, price_per_hour=0.38, net_gbps=16.0)
N2 = NodeSpec("N2", cpu=468, mem=17000, io_read=481, io_write=483,
              cores=8, power_watts=170, price_per_hour=0.44, net_gbps=16.0)
C2 = NodeSpec("C2", cpu=523, mem=18900, io_read=481, io_write=483,
              cores=8, power_watts=160, price_per_hour=0.50, net_gbps=16.0)

PAPER_MACHINES: Dict[str, NodeSpec] = {m.name: m for m in
                                       (LOCAL, A1, A2, N1, N2, C2)}
TARGET_MACHINES: List[NodeSpec] = [A1, A2, N1, N2, C2]


def make_cluster(node_counts: Dict[str, int]) -> List[NodeSpec]:
    """e.g. {'A1': 4, 'N2': 8} -> list of node instances."""
    nodes = []
    for name, count in node_counts.items():
        spec = PAPER_MACHINES[name]
        for i in range(count):
            nodes.append(NodeSpec(f"{name}-{i}", spec.cpu, spec.mem,
                                  spec.io_read, spec.io_write, spec.cores,
                                  spec.power_watts, spec.price_per_hour,
                                  spec.net_gbps))
    return nodes


# --- heterogeneous accelerator fleet (Lotaru-R integration) ----------------
TPU_FLEET: Dict[str, NodeRoofline] = {
    # name: peak bf16 FLOP/s, HBM B/s, ICI B/s per link
    "v5e": NodeRoofline("v5e", flops=197e12, hbm_bw=819e9, link_bw=50e9),
    "v4": NodeRoofline("v4", flops=275e12, hbm_bw=1228e9, link_bw=50e9),
    "v5p": NodeRoofline("v5p", flops=459e12, hbm_bw=2765e9, link_bw=100e9),
    "v6e": NodeRoofline("v6e", flops=918e12, hbm_bw=1640e9, link_bw=100e9),
    "cpu-host": NodeRoofline("cpu-host", flops=0.15e12, hbm_bw=40e9,
                             link_bw=3e9),
}
