"""The harness: finds a cell's files by name, runs its window, reads the
trace, and prints the result line."""
