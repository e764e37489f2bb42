from pint_jax.utils.oracle import Oracle

__all__ = ["Oracle"]
