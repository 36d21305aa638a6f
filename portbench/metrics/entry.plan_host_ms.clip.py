"""entry.plan_host_ms.clip: entry.plan_host_ms, read as its own reader
reads it, in the cells that send one clip a call and so report
samples_per_s.clip."""

from portbench import spec

read = spec.metric_reader("entry.plan_host_ms")
