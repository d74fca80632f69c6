"""``idle_share`` of a host-paced cell, where it moves ``qps.hostpaced``."""
from chipbench.harness import load_reader

read = load_reader("idle_share")
