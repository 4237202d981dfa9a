from lancet2_tpu_torch.base.dna import (
    ENCODE_TABLE,
    DECODE_TABLE,
    COMPLEMENT_CODE,
    encode,
    decode,
    revcomp_codes,
    revcomp_str,
)
from lancet2_tpu_torch.base.hashing import hash_str64, hash_u64_array, hash_kmer_matrix
from lancet2_tpu_torch.base.repeat import hamming_dist, has_exact_repeat, has_approx_repeat
from lancet2_tpu_torch.base.stats import (
    OnlineStats,
    median_u32,
    mann_whitney_effect_size,
    polar_radius,
    polar_angle,
)

__all__ = [
    "ENCODE_TABLE",
    "DECODE_TABLE",
    "COMPLEMENT_CODE",
    "encode",
    "decode",
    "revcomp_codes",
    "revcomp_str",
    "hash_str64",
    "hash_u64_array",
    "hash_kmer_matrix",
    "hamming_dist",
    "has_exact_repeat",
    "has_approx_repeat",
    "OnlineStats",
    "median_u32",
    "mann_whitney_effect_size",
    "polar_radius",
    "polar_angle",
]
