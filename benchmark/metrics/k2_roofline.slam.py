"""K2's share (%) of its roofline on the path: the least time of the
profiled slice's gated top-2 calls over the device time of K2's kernels
(``hamming_top2_mma_kernel`` and ``top2_merge_kernel``) in the slice. Each
frame makes one stereo call (features x features, stereo gate); every other
launch is counted at the map's shape (features x landmark capacity, window
gate), which tracking's three calls a frame have and loop verification's
ungated calls share in operations, the bound of both."""

from benchmark import profile
from benchmark.frozen import kernel_counts as kc


def read(run):
    p, n = run.get("profile"), run.get("launches", {}).get("K2", 0)
    if not p or not n:
        return None
    t, _ = profile.kernel_seconds(p, "hamming_top2", "top2_merge")
    if not t:
        return None
    s = run["settings"]
    na, nb = s["orb"]["num_features"], s["mapping"]["max_landmarks"]
    stereo = min(n, sum(1 for st in run["steps"] if st["traced"]))
    least = (stereo * kc.k2_bound_s(na, na, kc.GATE_STEREO)
             + (n - stereo) * kc.k2_bound_s(na, nb, kc.GATE_WINDOW))
    return 100.0 * least / t
