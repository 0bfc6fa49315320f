"""Two-stage retrieval: sparse doc candidates, then dense sentence re-rank.

Counterpart of ``ircl_tpu/pipeline/``, with the intrinsic claim/evidence
cosine (``intrinsic.py``) and the recall@k harness (``recall.py``).
"""
