"""Serving: the CNN image and LM engines, the port's copies of the scheduler,
the fault injector and the multi-model dispatcher."""
