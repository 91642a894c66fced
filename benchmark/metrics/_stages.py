"""The median over the synchronised staged calls of a sum of stages, in
ms (None where no call has them or they sum to 0)."""

import statistics


def median_ms(obs, pick):
    calls = obs.get("staged") or []
    sums = [sum(v for k, v in st.items() if pick(k)) for st in calls]
    if not sums or max(sums) <= 0:
        return None
    return statistics.median(sums) * 1e3
