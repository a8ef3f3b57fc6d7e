"""The general part of the port's benchmark: the cell's files found by
name, the import guard, the measured window, the device trace and the
result line.  What belongs to one configuration, traffic mix, job kind,
metric or kernel count lives in its own file beside this package."""
