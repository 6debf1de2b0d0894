"""Traffic loops, one file each (``spec``); a workload file names one
and gives its parameters."""
