"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch path (the versions it runs on the CPU), which imports nothing of
the program, so that the yardstick stays where it is when the program
moves."""
