"""setup_s: process start to the first timed request (corpus, traffic,
the program's index build, service and warm-up of every step shape the
traffic routes to, kernel builds on a checkout's first run)."""


def read(run):
    return run.setup_s
