"""Rows of the busiest expert over the mean expert's, a layer, averaged over
the MoE layers and the window's requests: the program's counters
(``VerdictClassifier.expert_counters``), read from the expert offsets that
come back with each request's probabilities."""


def read(run):
    c = run.info.get("expert_counters")
    if not c or not c["batches"]:
        return None
    return c["load_max_over_mean"] / c["batches"]
