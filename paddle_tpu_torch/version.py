"""Version info (the reference's ``version.py`` fields), the JAX
package's version."""

__version__ = "0.2.0"
full_version = __version__
major, minor, patch = (int(x) for x in __version__.split("."))
rc = 0


def show() -> None:
    print(f"paddle_tpu_torch {full_version}")
