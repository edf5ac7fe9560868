"""``queries_per_s``: query requests answered ``ok`` within the window,
over the window's seconds."""


def read(run):
    n = run.ok_in_window()
    return n / run.seconds if n else None
