"""IR, planner, plan cache and op registry (pure Python)."""
