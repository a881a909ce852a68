"""From the process's start to the window's start: imports, the kernels'
library (built on a checkout's first run, loaded after), the weights, and
one prefill and decode step at every shape the window runs."""


def read(run):
    return run.setup_s
