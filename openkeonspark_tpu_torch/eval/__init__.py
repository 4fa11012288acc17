from openkeonspark_tpu_torch.eval.link_prediction import (  # noqa: F401
    LinkPredictionResult, link_prediction)
from openkeonspark_tpu_torch.eval.classification import (  # noqa: F401
    fit_thresholds, triple_classification)
from openkeonspark_tpu_torch.eval.predict import (  # noqa: F401
    predict_head_entity, predict_relation, predict_tail_entity,
    predict_triple)
from openkeonspark_tpu_torch.eval.type_constrained import (  # noqa: F401
    type_constrained_link_prediction)
