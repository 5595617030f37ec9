"""tramp_tpu: an accelerator-native Tree-AMP (EP / state-evolution) inference
framework built on JAX/XLA, with the capabilities of sphinxteam/tramp.

Models are DAGs of priors, channels and likelihoods composed with ``@`` and
``+``; inference is jitted message passing over a statically lowered
schedule; instances/seeds batch via vmap and shard over device meshes."""

__version__ = "0.1.0"

from . import beliefs, utils, priors, channels, likelihoods, ensembles
from .variables import (
    SISOVariable, SIMOVariable, MISOVariable, MILeafVariable,
    SILeafVariable, MORootVariable, SORootVariable, V, O,
)
from .models import (
    Model, DAG, FactorDAG, ModelDAG, glm_generative, glm_state_evolution,
    MultiLayerModel, FactorModel,
)
from .algos import (
    ExpectationPropagation, StateEvolution, ConstantInit, NoisyInit,
    CustomInit, EarlyStopping, EarlyStoppingEP, METRICS,
)
