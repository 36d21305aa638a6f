"""device.program_idle_share.clip: device.program_idle_share, read as its
own reader reads it, in the cells that send one clip a call and so report
samples_per_s.clip."""

from portbench import spec

read = spec.metric_reader("device.program_idle_share")
