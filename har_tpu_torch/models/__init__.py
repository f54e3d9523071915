"""Classifiers: logistic regression, histogram trees, forests and boosted
trees, the neural families, ensembles and the bit-exact MLlib replays."""

from har_tpu_torch.models.base import Predictions, Classifier, ClassifierModel
from har_tpu_torch.models.gbdt import (
    GradientBoostedTreesClassifier,
    GradientBoostedTreesModel,
)
from har_tpu_torch.models.logistic_regression import (
    LogisticRegression,
    LogisticRegressionModel,
)
from har_tpu_torch.models.tree import DecisionTreeClassifier, DecisionTreeModel
from har_tpu_torch.models.forest import RandomForestClassifier, RandomForestModel
from har_tpu_torch.models.neural_classifier import (
    NeuralClassifier,
    NeuralClassifierModel,
)
from har_tpu_torch.models.ensemble import (
    VotingClassifier,
    VotingModel,
    seed_ensemble,
)
from har_tpu_torch.models.mllib_exact import (
    CrossValidatorExact,
    ExactDesign,
    LogisticRegressionExact,
    RandomForestExact,
)

__all__ = [
    "CrossValidatorExact",
    "ExactDesign",
    "LogisticRegressionExact",
    "RandomForestExact",
    "Predictions",
    "Classifier",
    "ClassifierModel",
    "GradientBoostedTreesClassifier",
    "GradientBoostedTreesModel",
    "LogisticRegression",
    "LogisticRegressionModel",
    "DecisionTreeClassifier",
    "DecisionTreeModel",
    "RandomForestClassifier",
    "RandomForestModel",
    "NeuralClassifier",
    "NeuralClassifierModel",
    "VotingClassifier",
    "VotingModel",
    "seed_ensemble",
]
