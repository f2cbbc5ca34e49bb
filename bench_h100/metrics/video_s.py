"""Window seconds over the videos the window completed: with two clients,
the card-seconds a video costs."""


def read(run):
    n = len(run.requests)
    if not n:
        return None
    return (run.window.t_close - run.window.t_open) / n
