"""The benchmark's own arithmetic: seeds, traffic, weights, operation and
byte counts, peaks, trace reduction and the output comparison.

Nothing here imports the program (``repro_torch``): the harness keeps its
yardstick apart from the code it measures, so that a change to the
program cannot move the yardstick.
"""
