"""The benchmark's general code: traffic, weights, the loading of the
model families, the drivers of the measured window, the trace, FLOP and
roofline arithmetic, and the comparison with the reference."""
