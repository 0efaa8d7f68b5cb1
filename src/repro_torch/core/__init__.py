"""Framework-free PANN core (power models, planner, policies, cost
profiles) plus the torch quantizers of the serving path."""
