"""Attempts a plan took, averaged over the traced plans: the planner's own
counter `MotionPlanner.last_attempts`, read after each plan."""


def read(run):
    recs = run.cell.records
    return sum(r["attempts"] for r in recs) / len(recs) if recs else None
