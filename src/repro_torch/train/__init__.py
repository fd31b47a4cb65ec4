"""Packed tree training: AdamW, the train step, the plan→execute engine,
the planner stand-in and checkpoints."""
