"""The control and the faults that the comparison deciding ``correct`` has
to catch, and the script that reads both beside the program's own runs."""
