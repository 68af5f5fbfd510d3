"""Display / environment adapters.

Counterpart of ``tempo_tpu/utils.py`` (parity with
python/tempo/utils.py:11-98): detect the runtime environment
(Databricks vs notebook vs terminal) and bind a ``display`` function that
renders a TSDF appropriately.  The HTML path degrades gracefully when
IPython is absent.
"""

from __future__ import annotations

import logging

import pandas as pd

from tempo_tpu_torch import config

logger = logging.getLogger(__name__)

PLATFORM = (
    "DATABRICKS"
    if config.env_external("DATABRICKS_RUNTIME_VERSION") is not None
    else "NON_DATABRICKS"
)


def __isnotebookenv() -> bool:
    try:
        from IPython import get_ipython  # type: ignore

        shell = get_ipython().__class__.__name__
        return shell == "ZMQInteractiveShell"
    except Exception:
        return False


def display_html(df) -> None:
    """Render a frame as HTML in notebook environments."""
    try:
        from IPython.core.display import HTML  # type: ignore
        from IPython.display import display as ipydisplay  # type: ignore

        ipydisplay(HTML("<style>pre { white-space: pre !important; }</style>"))
    except Exception as e:
        # cosmetic only, but never swallowed silently
        logger.debug("notebook HTML styling unavailable: %s", e)
    if isinstance(df, pd.DataFrame):
        print(df.head(20).to_string(index=False))
    else:
        logger.error("'display' method not available for this object")


def display_unavailable(df) -> None:
    logger.error(
        "'display' method not available in this environment. Use 'show' method instead."
    )


ENV_BOOLEAN = __isnotebookenv()


def _frame_of(obj):
    return obj.df if type(obj).__name__ == "TSDF" else obj


def _databricks_native_display():
    """The Databricks notebook's own ``display`` from the IPython user
    namespace (reference utils.py:57-60) — the rich-table binding users
    expect on that platform; None when unavailable."""
    try:
        from IPython import get_ipython  # type: ignore

        return get_ipython().user_ns["display"]
    except Exception:
        return None


if PLATFORM == "DATABRICKS" and _databricks_native_display() is not None:
    method = _databricks_native_display()

    def display_improvised(obj):
        """Parity: reference utils.py:61-66 — route through the
        notebook's native display, unwrapping TSDFs."""
        method(_frame_of(obj))

    display = display_improvised
elif ENV_BOOLEAN:

    def display_html_improvised(obj):
        display_html(_frame_of(obj))

    display = display_html_improvised
else:

    def display_terminal(obj):
        df = _frame_of(obj)
        if isinstance(df, pd.DataFrame):
            print(df.head(20).to_string(index=False))
        else:
            display_unavailable(df)

    display = display_terminal
