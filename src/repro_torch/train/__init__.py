"""Training support. Only ``fault_tolerance.DataSkipper`` is ported yet;
the trainer, optimizer and checkpointing wait for the training slice
(ROADMAP A8c)."""
