"""One module per task a workload names (``"task"``): how the program is
set up from the generated inputs, what one timed call is, and how its
output is checked against the plain reference (``benchmark/reference``)."""
