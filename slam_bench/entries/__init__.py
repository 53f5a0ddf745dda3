"""How a traffic mix hands frames to the program: one module per entry of
the program, named by the mix's `entry` and found by that name."""
