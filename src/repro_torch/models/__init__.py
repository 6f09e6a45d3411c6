"""The model stack on torch: config-driven transformer blocks, the
planner's model graphs and the plan->policy projection."""
