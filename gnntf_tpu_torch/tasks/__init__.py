from .base import Predictor
from .link_prediction import (LinkPrediction, MeanLinkPrediction,
                              negative_sampling, recommend_all)
from .node_classification import NodeClassification
