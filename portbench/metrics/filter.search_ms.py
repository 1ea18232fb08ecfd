"""Mean synced span of the index's filtered `search`, per call, in ms:
search.ms's reading, in the filtered cells."""

from portbench import harness

read = harness.load_module("metrics", "search.ms").read
