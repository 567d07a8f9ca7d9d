"""Animation drivers (rt_tpu/drivers): frame sequences, the frame farm
and video assembly."""
