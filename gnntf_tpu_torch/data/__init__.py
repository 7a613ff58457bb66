from .loaders import (custom_splits, dgl_setup, enrich_features, load,
                      ogb_setup, random_splits, sample_edges, tpl_setup)
from .synthetic import random_power_law_edges, synthetic_planetoid
