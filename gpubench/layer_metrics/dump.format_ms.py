"""The dump's formatting on the host (the count filter, ``lanes_to_words``,
``serialize_table``): the program's ``dump.format`` span (a timer), ms a
count (summed over the traced window's counts, divided by the counts)."""


def read(window):
    return window.timer_ms_per_count("dump.format")
