"""The evidence DP's pair and output layout, without torch.

Phase A's pair builder (caller/genotyper.py, `build_pair_indices`) shapes
each pair's region slots by R_MAX, and the genotyper's assembly reads the
outputs by these keys. This module imports nothing, so that the prep
coordinator and its fork workers, which never touch the device, do not
pay for importing torch. The plain version and the kernel wrappers take
the same names from here.
"""

R_MAX = 4  # region slots per pair, as lancet2_tpu.ops.evidence_dp.R_MAX
BIG_BQ = 255

REGION_INT_KEYS = ("qv", "aligned", "min_bq")
REGION_FLOAT_KEYS = ("raw", "pbq", "matches")
SPAN_KEYS = ("score", "t_end", "t_start", "nm")
REGION_FILL = {"qv": -1, "aligned": 0, "min_bq": BIG_BQ,
               "raw": 0.0, "pbq": 0.0, "matches": 0.0}
