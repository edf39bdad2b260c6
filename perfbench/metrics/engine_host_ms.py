"""The engine's own time per request outside its two forwards: serve()'s
wall - the plan's wall - the monolithic forward's wall (both
synchronized), mean over the requests of a traced run's window, in ms.
It holds the MAB's decision, DASO's placement ascent and training, the
fidelity and the host-to-device copies of the request."""


def read(run):
    if not run.ok:
        return None
    return 1e3 * sum(r["latency_s"] - r["plan_s"] - r["mono_s"]
                     for r in run.ok) / len(run.ok)
