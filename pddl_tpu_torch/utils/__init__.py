"""Framework-level utilities shared by the port's subsystems (the port's
own copies of what it needs from :mod:`pddl_tpu.utils`)."""
