"""Serving: the CNN image engine and the port's copy of the scheduler."""
