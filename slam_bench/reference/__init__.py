"""The plain reference the benchmark judges the program by: imports
nothing of the program."""
