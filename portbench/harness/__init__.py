"""The benchmark's harness: it resolves a cell from its files, drives the
measured package through the cell's traffic, times the window, reads the
traced window and compares what the timed path produced with the plain
reference (``portbench/reference``)."""
