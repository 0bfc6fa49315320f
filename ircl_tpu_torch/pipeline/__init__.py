"""Two-stage retrieval: sparse doc candidates, then dense sentence re-rank.

Counterpart of ``ircl_tpu/pipeline/``, with the intrinsic claim/evidence
cosine (``intrinsic.py``); the recall@k harness is not ported yet
(ROADMAP.md queue 1 item 7).
"""
