"""The paper's core (port of ``repro/core``): metadata, rules, SlimAdam, SNR,
and the baselines the paper compares against."""
from . import baselines
from .labels import STRUCTURAL_AXES, ParamMeta, flatten_with_names, path_str, validate_meta
from .rules import (DEFAULT_CUTOFF, Rule, derive_rules, rules_as_tree, rules_to_dims, second_moment_savings,
                    table3_rules)
from .slim_adam import ScaleBySlimAdamState, scale_by_slim_adam, second_moment_elements, slim_adam
from .snr import (SNRTracker, compression_ratio, measure_leaf_snr, measure_leaf_snr_per_layer, measure_tree_snr,
                  snr_along_dims)

__all__ = ["ParamMeta", "STRUCTURAL_AXES", "flatten_with_names", "path_str", "validate_meta", "SNRTracker",
           "compression_ratio", "measure_leaf_snr", "measure_leaf_snr_per_layer", "measure_tree_snr",
           "snr_along_dims", "DEFAULT_CUTOFF", "Rule", "derive_rules", "rules_as_tree", "rules_to_dims",
           "second_moment_savings", "table3_rules", "ScaleBySlimAdamState", "scale_by_slim_adam",
           "second_moment_elements", "slim_adam", "baselines"]
