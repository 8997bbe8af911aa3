"""The share of the traced window, %, in which no kernel, copy or fill ran
on the card."""


def read(window):
    if window.busy_s is None or not window.window_s:
        return None
    return 100.0 * (1.0 - window.busy_s / window.window_s)
