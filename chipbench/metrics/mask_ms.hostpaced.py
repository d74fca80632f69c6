"""``mask_ms`` of a host-paced cell, where it moves ``qps.hostpaced``."""
from chipbench.harness import load_reader

read = load_reader("mask_ms")
