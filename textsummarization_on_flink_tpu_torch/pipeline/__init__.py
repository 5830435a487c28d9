"""The pipeline layer: Estimator.fit -> Model.transform over row streams,
the App and the deprecated raw driver (the reference's own main path,
SURVEY.md §3.1-§3.2)."""

from textsummarization_on_flink_tpu_torch.pipeline import bridge  # noqa: F401
from textsummarization_on_flink_tpu_torch.pipeline import codec  # noqa: F401
from textsummarization_on_flink_tpu_torch.pipeline import estimator  # noqa: F401
from textsummarization_on_flink_tpu_torch.pipeline import io  # noqa: F401
from textsummarization_on_flink_tpu_torch.pipeline import params  # noqa: F401
from textsummarization_on_flink_tpu_torch.pipeline import app  # noqa: F401
