"""Share of the filtered cell's traced window in which the profiler shows
no device operation, in %: device.idle_pct's reading, in the filtered
cells."""

from portbench import harness

read = harness.load_module("metrics", "device.idle_pct").read
