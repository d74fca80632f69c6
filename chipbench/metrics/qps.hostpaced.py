"""``qps`` of a host-paced cell (the graph route), whose runs spread with
the host's speed and so stand under a bound of their own."""
from chipbench.harness import load_reader

read = load_reader("qps")
