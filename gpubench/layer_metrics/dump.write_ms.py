"""The dump's write (opening the output and writing the records; in the
benchmark a named pipe that the harness reads): the program's
``dump.write`` span (a timer), ms a count (summed over the traced window's
counts, divided by the counts)."""


def read(window):
    return window.timer_ms_per_count("dump.write")
