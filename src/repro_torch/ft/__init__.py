"""Fault tolerance for the serving path: the straggler watchdog, the
preemption checkpointer and the seeded chaos engine."""
