"""Device milliseconds per train step of the layout transposes around
cuDNN's convolutions: the kernels whose names match ``PATTERNS`` in the
traced stretch, over its steps. Reads nothing where none matches."""

import re

PATTERNS = re.compile(r"nchwToNhwc|nhwcToNchw|nchw_to_nhwc|nhwc_to_nchw|transpose", re.I)


def read(run):
    st = run.stretch
    if st is None or st.unit != "step":
        return None
    hits = [t for name, (t, _) in st.by_name().items() if PATTERNS.search(name)]
    if not hits:
        return None
    return 1e3 * sum(hits) / st.units
