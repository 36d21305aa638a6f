"""kernel.b2_roofline.clip: kernel.b2_roofline, read as its own reader
reads it, in the cells that send one clip a call and so report
samples_per_s.clip."""

from portbench import spec

read = spec.metric_reader("kernel.b2_roofline")
