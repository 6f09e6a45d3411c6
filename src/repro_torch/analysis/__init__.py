"""repro_torch.analysis — backend-free static verification of EinGraphs, plans,
and collective schedules.

Four passes, ruff-style ``RA`` codes (``findings.CODES`` is the index):

  graph    (RA0xx)  labels, bounds, dtypes, OpDef signature conformance
  plan     (RA1xx)  divisibility, mesh axes, shard rules, §7 cost honesty
  schedule (RA2xx)  ppermute bijectivity, donation aliasing, chain shapes,
                    double-buffer overlap, traced ≤ priced
  memory   (RA3xx)  peak per-device live bytes vs --max-hbm

Everything runs without allocating a tensor or initializing CUDA — planning
and schedule lowering are pure Python over static shapes.  CLI::

    python -m repro_torch.analysis --families all --mesh data=2,model=4
"""
from repro_torch.analysis.findings import CODES, ERROR, Finding, Report, WARNING
from repro_torch.analysis.graph_pass import analyze_graph
from repro_torch.analysis.memory_pass import analyze_memory
from repro_torch.analysis.plan_pass import analyze_plan
from repro_torch.analysis.runner import (analyze, analyze_compiled,
                                   analyze_program, analyze_schedule_only)
from repro_torch.analysis.schedule_pass import analyze_schedule

__all__ = [
    "CODES", "ERROR", "WARNING", "Finding", "Report",
    "analyze", "analyze_graph", "analyze_plan", "analyze_schedule",
    "analyze_memory", "analyze_program", "analyze_compiled",
    "analyze_schedule_only",
]
