"""Typed pipeline-parameter system (the WithParams/ParamInfo layer).

A copy of the JAX package's pipeline/params.py, after the reference's
Flink-ML param mixins (param/*.java): typed ``ParamInfo`` declarations
with required/optional semantics and defaults, a ``Params`` store with a
JSON round trip (models persist as params-JSON only,
TensorFlowTest.java:142-168), and the same eight mixin groups, with
train and inference kept apart so an estimator and its model can
diverge (Flink-AI-Extended Integration Report.md:30).  The JSON of a
params set is the same string in both packages, so a model JSON written
by one loads in the other.

Names against the reference:
  * zookeeper_connect_str -> coordinator_address: the rendezvous address
    of a multi-process job (HasClusterConfig.java:15-19);
  * worker_num / ps_num keep their names; ps_num exists for surface
    parity and must be 0: there is no parameter server
    (HasClusterConfig.java:20-29);
  * *_scripts: the entry is in-process, so scripts hold importable entry
    names instead of file paths;
  * *_hyper_params: the reference's argv strings (TFEstimator.java:52),
    parsed by ``HParams.from_string``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, Generic, List, Optional, Type, TypeVar

T = TypeVar("T")


class ParamValidators:
    @staticmethod
    def always_true() -> Callable[[Any], bool]:
        return lambda v: True

    @staticmethod
    def gt_eq(bound: float) -> Callable[[Any], bool]:
        return lambda v: v is not None and v >= bound

    @staticmethod
    def non_empty() -> Callable[[Any], bool]:
        return lambda v: v is not None and len(v) > 0


@dataclasses.dataclass(frozen=True)
class ParamInfo(Generic[T]):
    """A typed parameter declaration (ParamInfoFactory parity)."""

    name: str
    description: str
    type_: Type
    required: bool = False
    has_default: bool = False
    default: Optional[T] = None
    validator: Callable[[Any], bool] = lambda v: True

    def __hash__(self) -> int:
        return hash(self.name)


class Params:
    """The param store (org.apache.flink.ml.api.misc.param.Params parity):
    get falls back to defaults, raises on missing required params; JSON
    round-trip for model persistence."""

    def __init__(self) -> None:
        self._map: Dict[str, Any] = {}

    def set(self, info: ParamInfo, value: Any) -> "Params":
        if value is not None and not isinstance(value, info.type_) and not (
                info.type_ is float and isinstance(value, int)):
            raise TypeError(
                f"param {info.name} expects {info.type_.__name__}, "
                f"got {type(value).__name__}")
        if not info.validator(value):
            raise ValueError(f"invalid value for param {info.name}: {value!r}")
        self._map[info.name] = value
        return self

    def get(self, info: ParamInfo) -> Any:
        if info.name in self._map:
            return self._map[info.name]
        if info.has_default:
            return info.default
        if info.required:
            raise KeyError(f"required param {info.name} is not set")
        return None

    def contains(self, info: ParamInfo) -> bool:
        return info.name in self._map

    def remove(self, info: ParamInfo) -> None:
        self._map.pop(info.name, None)

    def size(self) -> int:
        return len(self._map)

    # -- persistence (config-only model JSON, TFModel.toJson parity) --
    def to_json(self) -> str:
        return json.dumps(self._map, sort_keys=True)

    def load_json(self, s: str) -> "Params":
        self._map.update(json.loads(s))
        return self

    @classmethod
    def from_json(cls, s: str) -> "Params":
        return cls().load_json(s)


class WithParams:
    """Base mixin: everything stores into self.params (WithParams parity)."""

    def __init__(self) -> None:
        self._params = Params()

    @property
    def params(self) -> Params:
        return self._params

    def _get(self, info: ParamInfo) -> Any:
        return self._params.get(info)

    def _set(self, info: ParamInfo, v: Any) -> "WithParams":
        self._params.set(info, v)
        return self

    @classmethod
    def param_infos(cls) -> Dict[str, ParamInfo]:
        """All ParamInfo declarations visible on this class (over the MRO)."""
        out: Dict[str, ParamInfo] = {}
        for klass in cls.__mro__:
            for v in vars(klass).values():
                if isinstance(v, ParamInfo):
                    out.setdefault(v.name, v)
        return out

    def load_params_json(self, s: str) -> "WithParams":
        """JSON -> params, re-validating every DECLARED param through the
        typed set() path (bare Params.load_json skips type checks; model
        JSON arrives from untrusted files, TensorFlowTest.java:152-163)."""
        loaded = json.loads(s)
        infos = self.param_infos()
        for name, value in loaded.items():
            if name in infos:
                self._params.set(infos[name], value)
            else:
                self._params._map[name] = value  # unknown: keep, like Flink
        return self


# --------------------------------------------------------------------------
# The eight param groups (§2.1 of SURVEY.md)
# --------------------------------------------------------------------------

class HasClusterConfig(WithParams):
    """HasClusterConfig.java:15-29 (defaults preserved)."""

    COORDINATOR_ADDRESS = ParamInfo(
        "coordinator_address",
        "distributed coordination service address (the reference's "
        "zookeeper_connect_str)",
        str, has_default=True, default="127.0.0.1:2181")
    WORKER_NUM = ParamInfo(
        "worker_num", "number of training hosts", int,
        has_default=True, default=1, validator=ParamValidators.gt_eq(1))
    PS_NUM = ParamInfo(
        "ps_num", "parameter servers (surface parity only; must be 0: "
        "there is no PS role)", int,
        has_default=True, default=0, validator=ParamValidators.gt_eq(0))

    def set_coordinator_address(self, v: str): return self._set(self.COORDINATOR_ADDRESS, v)
    def get_coordinator_address(self) -> str: return self._get(self.COORDINATOR_ADDRESS)
    def set_worker_num(self, v: int): return self._set(self.WORKER_NUM, v)
    def get_worker_num(self) -> int: return self._get(self.WORKER_NUM)
    def set_ps_num(self, v: int): return self._set(self.PS_NUM, v)
    def get_ps_num(self) -> int: return self._get(self.PS_NUM)
    # reference-name aliases
    set_zookeeper_connect_str = set_coordinator_address
    get_zookeeper_connect_str = get_coordinator_address


class HasTrainPythonConfig(WithParams):
    """HasTrainPythonConfig.java (scripts/map-func/hyperparams/env)."""

    TRAIN_SCRIPTS = ParamInfo(
        "train_scripts", "training entry names", list,
        has_default=True, default=None)
    TRAIN_MAP_FUNC = ParamInfo(
        "train_map_func", "training entry function", str,
        has_default=True, default="main_on_flink")
    TRAIN_HYPER_PARAMS_KEY = ParamInfo(
        "train_hyper_params_key", "property key the hyperparams travel "
        "under (reference: TF_Hyperparameter)", str,
        has_default=True, default="TF_Hyperparameter")
    TRAIN_HYPER_PARAMS = ParamInfo(
        "train_hyper_params", "training hyperparameter argv strings", list,
        has_default=True, default=None)
    TRAIN_ENV_PATH = ParamInfo(
        "train_env_path", "virtualenv path (unused in-process)", str,
        has_default=True, default=None)

    def set_train_scripts(self, v: List[str]): return self._set(self.TRAIN_SCRIPTS, v)
    def get_train_scripts(self) -> Optional[List[str]]: return self._get(self.TRAIN_SCRIPTS)
    def set_train_map_func(self, v: str): return self._set(self.TRAIN_MAP_FUNC, v)
    def get_train_map_func(self) -> str: return self._get(self.TRAIN_MAP_FUNC)
    def set_train_hyper_params_key(self, v: str): return self._set(self.TRAIN_HYPER_PARAMS_KEY, v)
    def get_train_hyper_params_key(self) -> str: return self._get(self.TRAIN_HYPER_PARAMS_KEY)
    def set_train_hyper_params(self, v: List[str]): return self._set(self.TRAIN_HYPER_PARAMS, v)
    def get_train_hyper_params(self) -> Optional[List[str]]: return self._get(self.TRAIN_HYPER_PARAMS)
    def set_train_env_path(self, v: str): return self._set(self.TRAIN_ENV_PATH, v)
    def get_train_env_path(self) -> Optional[str]: return self._get(self.TRAIN_ENV_PATH)


class HasInferencePythonConfig(WithParams):
    """HasInferencePythonConfig.java — duplicated, not shared, with the
    train group, so estimator and model can diverge (Integration Report:30)."""

    INFERENCE_SCRIPTS = ParamInfo(
        "inference_scripts", "inference entry names", list,
        has_default=True, default=None)
    INFERENCE_MAP_FUNC = ParamInfo(
        "inference_map_func", "inference entry function", str,
        has_default=True, default="main_on_flink")
    INFERENCE_HYPER_PARAMS_KEY = ParamInfo(
        "inference_hyper_params_key", "property key the hyperparams travel "
        "under (reference: TF_Hyperparameter)", str,
        has_default=True, default="TF_Hyperparameter")
    INFERENCE_HYPER_PARAMS = ParamInfo(
        "inference_hyper_params", "inference hyperparameter argv strings",
        list, has_default=True, default=None)
    INFERENCE_ENV_PATH = ParamInfo(
        "inference_env_path", "virtualenv path (unused in-process)", str,
        has_default=True, default=None)

    def set_inference_scripts(self, v: List[str]): return self._set(self.INFERENCE_SCRIPTS, v)
    def get_inference_scripts(self) -> Optional[List[str]]: return self._get(self.INFERENCE_SCRIPTS)
    def set_inference_map_func(self, v: str): return self._set(self.INFERENCE_MAP_FUNC, v)
    def get_inference_map_func(self) -> str: return self._get(self.INFERENCE_MAP_FUNC)
    def set_inference_hyper_params_key(self, v: str): return self._set(self.INFERENCE_HYPER_PARAMS_KEY, v)
    def get_inference_hyper_params_key(self) -> str: return self._get(self.INFERENCE_HYPER_PARAMS_KEY)
    def set_inference_hyper_params(self, v: List[str]): return self._set(self.INFERENCE_HYPER_PARAMS, v)
    def get_inference_hyper_params(self) -> Optional[List[str]]: return self._get(self.INFERENCE_HYPER_PARAMS)
    def set_inference_env_path(self, v: str): return self._set(self.INFERENCE_ENV_PATH, v)
    def get_inference_env_path(self) -> Optional[str]: return self._get(self.INFERENCE_ENV_PATH)


class HasTrainSelectedCols(WithParams):
    TRAIN_SELECTED_COLS = ParamInfo(
        "train_selected_cols", "input columns selected for training", list,
        required=True, validator=ParamValidators.non_empty())

    def set_train_selected_cols(self, v: List[str]): return self._set(self.TRAIN_SELECTED_COLS, v)
    def get_train_selected_cols(self) -> List[str]: return self._get(self.TRAIN_SELECTED_COLS)


class HasTrainOutputCols(WithParams):
    TRAIN_OUTPUT_COLS = ParamInfo(
        "train_output_cols", "output columns of the training stage", list,
        has_default=True, default=None)

    def set_train_output_cols(self, v: List[str]): return self._set(self.TRAIN_OUTPUT_COLS, v)
    def get_train_output_cols(self) -> Optional[List[str]]: return self._get(self.TRAIN_OUTPUT_COLS)


class HasTrainOutputTypes(WithParams):
    TRAIN_OUTPUT_TYPES = ParamInfo(
        "train_output_types", "output column wire types (DataTypes names)",
        list, has_default=True, default=None)

    def set_train_output_types(self, v: List[str]): return self._set(self.TRAIN_OUTPUT_TYPES, v)
    def get_train_output_types(self) -> Optional[List[str]]: return self._get(self.TRAIN_OUTPUT_TYPES)


class HasInferenceSelectedCols(WithParams):
    INFERENCE_SELECTED_COLS = ParamInfo(
        "inference_selected_cols", "input columns selected for inference",
        list, required=True, validator=ParamValidators.non_empty())

    def set_inference_selected_cols(self, v: List[str]): return self._set(self.INFERENCE_SELECTED_COLS, v)
    def get_inference_selected_cols(self) -> List[str]: return self._get(self.INFERENCE_SELECTED_COLS)


class HasInferenceOutputCols(WithParams):
    INFERENCE_OUTPUT_COLS = ParamInfo(
        "inference_output_cols", "output columns of the inference stage",
        list, required=True, validator=ParamValidators.non_empty())

    def set_inference_output_cols(self, v: List[str]): return self._set(self.INFERENCE_OUTPUT_COLS, v)
    def get_inference_output_cols(self) -> List[str]: return self._get(self.INFERENCE_OUTPUT_COLS)


class HasInferenceOutputTypes(WithParams):
    INFERENCE_OUTPUT_TYPES = ParamInfo(
        "inference_output_types", "output column wire types (DataTypes names)",
        list, required=True, validator=ParamValidators.non_empty())

    def set_inference_output_types(self, v: List[str]): return self._set(self.INFERENCE_OUTPUT_TYPES, v)
    def get_inference_output_types(self) -> List[str]: return self._get(self.INFERENCE_OUTPUT_TYPES)
