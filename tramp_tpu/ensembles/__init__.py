"""Random matrix ensembles. Key-based jax sampling.
Reference tramp/ensembles/ (registry __init__.py:11-26)."""
import numpy as np
import jax
import jax.numpy as jnp

from .marchenko_pastur_ensemble import MarchenkoPasturEnsemble


class Ensemble:
    def __repr__(self):
        args = ", ".join(
            f"{k}={v!r}" for k, v in self.__dict__.items())
        return f"{type(self).__name__}({args})"


class GaussianEnsemble(Ensemble):
    "iid N(0, 1/N). Reference gaussian_ensemble.py:5-22."

    def __init__(self, M, N):
        self.M = M
        self.N = N

    def generate(self, key=None):
        key = jax.random.PRNGKey(0) if key is None else key
        return jax.random.normal(key, (self.M, self.N)) / jnp.sqrt(self.N)


class ComplexGaussianEnsemble(Ensemble):
    "Complex iid, real/imag N(0, 1/N). Reference complex_gaussian_ensemble.py."

    def __init__(self, M, N):
        self.M = M
        self.N = N

    def generate(self, key=None):
        # complex assembled HOST-SIDE (numpy): the matrix is a
        # construction-time constant consumed by the packed-real channels
        key = jax.random.PRNGKey(0) if key is None else key
        k1, k2 = jax.random.split(key)
        s = 1.0 / np.sqrt(self.N)
        return (s * np.asarray(jax.random.normal(k1, (self.M, self.N)))
                + 1j * s * np.asarray(jax.random.normal(k2, (self.M, self.N))))


class RotationEnsemble(Ensemble):
    "Haar SO(N) matrix. Reference rotation_ensemble.py:5-19."

    def __init__(self, N):
        self.N = N

    def generate(self, key=None):
        key = jax.random.PRNGKey(0) if key is None else key
        A = jax.random.normal(key, (self.N, self.N))
        Q, R = jnp.linalg.qr(A)
        Q = Q * jnp.sign(jnp.diag(R))
        # force determinant +1 (SO(N))
        det = jnp.linalg.det(Q)
        Q = Q.at[:, 0].multiply(jnp.sign(det))
        return Q


class UnitaryEnsemble(Ensemble):
    "Haar U(N) matrix. Reference unitary_ensemble.py:5-19."

    def __init__(self, N):
        self.N = N

    def generate(self, key=None):
        # host-side numpy complex QR (see ComplexGaussianEnsemble.generate)
        key = jax.random.PRNGKey(0) if key is None else key
        k1, k2 = jax.random.split(key)
        A = (np.asarray(jax.random.normal(k1, (self.N, self.N)))
             + 1j * np.asarray(jax.random.normal(k2, (self.N, self.N))))
        Q, R = np.linalg.qr(A)
        d = np.diag(R)
        return Q * (d / np.abs(d))


class BinaryEnsemble(Ensemble):
    """iid +-1/sqrt(N) with P(+) = p_pos.
    Reference binary_ensemble.py:5-28 (note: the reference has a latent bug
    `self.p_pos` no-op at l:9; we implement the documented behavior)."""

    def __init__(self, M, N, p_pos=0.5):
        self.M = M
        self.N = N
        self.p_pos = p_pos

    def generate(self, key=None):
        key = jax.random.PRNGKey(0) if key is None else key
        u = jax.random.uniform(key, (self.M, self.N))
        return jnp.where(u < self.p_pos, 1.0, -1.0) / jnp.sqrt(self.N)


class TernaryEnsemble(Ensemble):
    "iid {+1, 0, -1}/sqrt(N). Reference ternary_ensemble.py:5-33."

    def __init__(self, M, N, p_pos=0.33, p_neg=0.33):
        self.M = M
        self.N = N
        self.p_pos = p_pos
        self.p_neg = p_neg
        self.p_zero = 1.0 - p_pos - p_neg

    def generate(self, key=None):
        key = jax.random.PRNGKey(0) if key is None else key
        u = jax.random.uniform(key, (self.M, self.N))
        x = jnp.where(u < self.p_neg, -1.0,
                      jnp.where(u < self.p_neg + self.p_zero, 0.0, 1.0))
        return x / jnp.sqrt(self.N)


class RandomFeatureEnsemble(Ensemble):
    "X = f(WZ)/sqrt(N). Reference random_feature_ensemble.py:27-55."

    ACTIVATIONS = {
        "relu": lambda x: jnp.maximum(x, 0.0),
        "relu_zero_mean": lambda x: jnp.maximum(x, 0.0)
        - 1.0 / jnp.sqrt(2 * jnp.pi),
        "abs_zero_mean": lambda x: jnp.abs(x) - jnp.sqrt(2.0 / jnp.pi),
        "abs": jnp.abs,
        "tanh": jnp.tanh,
        "sgn": jnp.sign,
    }

    def __init__(self, M, N, f):
        self.M = M
        self.N = N
        self.f_name = f
        self.f = self.ACTIVATIONS[f]

    def generate(self, key=None):
        key = jax.random.PRNGKey(0) if key is None else key
        k1, k2 = jax.random.split(key)
        Z = jax.random.normal(k1, (self.N, self.N)) / jnp.sqrt(self.N)
        W = jax.random.normal(k2, (self.M, self.N))
        return self.f(W @ Z) / jnp.sqrt(self.N)


class ComplexUnitaryEnsemble(Ensemble):
    "Random phases e^{i phi}. Reference complex_unitary_ensemble.py:5-24."

    def __init__(self, M, N, scale=1):
        self.M = M
        self.N = N
        self.scale = scale

    def generate(self, key=None):
        # host-side numpy complex phases (see ComplexGaussianEnsemble)
        key = jax.random.PRNGKey(0) if key is None else key
        phi = np.asarray(jax.random.uniform(key, (self.M, self.N)))
        return np.exp(2j * np.pi * phi)


ENSEMBLE_CLASSES = {
    "gaussian": GaussianEnsemble,
    "complex_gaussian": ComplexGaussianEnsemble,
    "rotation": RotationEnsemble,
    "unitary": UnitaryEnsemble,
    "binary": BinaryEnsemble,
    "ternary": TernaryEnsemble,
    "marchenko": MarchenkoPasturEnsemble,
    "random_feature": RandomFeatureEnsemble,
    "complex_unitary": ComplexUnitaryEnsemble,
}


def get_ensemble(ensemble_type, **kwargs):
    return ENSEMBLE_CLASSES[ensemble_type](**kwargs)
