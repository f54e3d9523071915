"""The benchmark's own library: finding a cell's files by name, seeds,
the yardstick (peaks, bounds), the profiler summary and the result line.

Nothing here imports the program (``har_tpu_torch``); the drivers under
``perfbench/drivers`` do, and the plain reference under
``perfbench/reference`` never does.
"""
