"""recall_at_k: mean recall@k over every answer of the window, against the
reference's exact filtered top-k (judge.py)."""


def read(run):
    return run.verdict.recall
