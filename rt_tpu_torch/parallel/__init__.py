"""Multi-process helpers (rt_tpu/parallel): the frame farm's split.
Multi-device rendering and training are not ported yet (ROADMAP Queue
A-9)."""
