"""Tools that set the benchmark's numbers once, on the card: the knee
sweep of an open-loop mix, and the readings the correctness limits are set
from. The benchmark's own runs do not run them."""
