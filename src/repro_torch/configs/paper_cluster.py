"""The paper's own experimental configurations (Sections 2-3), exposed next
to the assigned-architecture configs for discoverability.

  ILLUSTRATIVE       the Section-2 2x2 example (Eqs. (1)-(2))
  HETEROGENEOUS      Section 3.3: six AWS c3.2xlarge agents, 3 types
  HOMOGENEOUS        Section 3.6: six type-3 agents
  FIG9               Section 3.7: one agent of each type
  PI / WC            the two Spark submission groups' executor demands
"""
from repro_torch.core.instance import (
    paper_example,
    spark_cluster_fig9,
    spark_cluster_heterogeneous,
    spark_cluster_homogeneous,
)
from repro_torch.core.simulator import HETEROGENEOUS_AGENTS, HOMOGENEOUS_AGENTS, PI, WC

ILLUSTRATIVE = paper_example
HETEROGENEOUS = spark_cluster_heterogeneous
HOMOGENEOUS = spark_cluster_homogeneous
FIG9 = spark_cluster_fig9

__all__ = [
    "ILLUSTRATIVE", "HETEROGENEOUS", "HOMOGENEOUS", "FIG9",
    "HETEROGENEOUS_AGENTS", "HOMOGENEOUS_AGENTS", "PI", "WC",
]
