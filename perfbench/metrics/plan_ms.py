"""The executed plan's wall, synchronized before and after, mean over the
requests of a traced run's window, in ms."""


def read(run):
    if not run.ok:
        return None
    return 1e3 * sum(r["plan_s"] for r in run.ok) / len(run.ok)
