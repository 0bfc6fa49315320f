"""Self time of the program span ``ranker.vectorize`` a traced batch, in ms:
the query vectorizer (``vectorize_queries``: C++ tokens and hashes, tf-idf
weights, the padded [B, T] arrays)."""

from benchmark.program_spans import self_ms


def read(run):
    return self_ms(run, "ranker.vectorize")
