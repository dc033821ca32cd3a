"""Server plugin SPIs.

Counterpart of ``incubator_predictionio_tpu/server/plugins.py``, whole: the
engine- and event-server plugin registries, :func:`apply_output_plugins`
(the query server's output path) and :func:`apply_input_plugins` (for the
event server, ROADMAP.md item 7).

Parity targets:
- Engine server plugins (core/.../workflow/EngineServerPlugin.scala:24-41):
  ``outputblocker`` synchronously transforms the prediction JSON on the query
  path; ``outputsniffer`` observes it asynchronously.
- Event server plugins (data/.../api/EventServerPlugin.scala:22):
  ``inputblocker`` can reject/transform incoming event JSON; ``inputsniffer``
  observes it.

Mechanism swap: the reference discovers plugins via java ServiceLoader
(EngineServerPluginContext.scala:57); here plugins register explicitly (import
side effect or programmatic call) — the same replacement the storage registry
makes for class-name reflection.
"""

from __future__ import annotations

import abc
import logging
from typing import Any

logger = logging.getLogger(__name__)


class EngineServerPlugin(abc.ABC):
    """(EngineServerPlugin.scala:24)"""

    OUTPUTBLOCKER = "outputblocker"
    OUTPUTSNIFFER = "outputsniffer"

    name: str = "plugin"
    description: str = ""
    output_type: str = OUTPUTSNIFFER

    def start(self, context: Any) -> None:
        pass

    @abc.abstractmethod
    def process(self, engine_instance: Any, query: dict, prediction: Any,
                context: Any) -> Any:
        """outputblocker: return the (possibly transformed) prediction;
        outputsniffer: return value ignored."""

    def handle_rest(self, path: str, params: dict) -> Any:
        """Backs /plugins/<type>/<name>/* routes."""
        return {}


class EventServerPlugin(abc.ABC):
    """(EventServerPlugin.scala:22)"""

    INPUTBLOCKER = "inputblocker"
    INPUTSNIFFER = "inputsniffer"

    name: str = "plugin"
    description: str = ""
    input_type: str = INPUTSNIFFER

    def start(self, context: Any) -> None:
        pass

    @abc.abstractmethod
    def process(self, event_info: dict, context: Any) -> Any:
        """inputblocker: raise to reject, or return transformed event JSON;
        inputsniffer: return value ignored."""

    def handle_rest(self, path: str, params: dict) -> Any:
        return {}


ENGINE_SERVER_PLUGINS: dict[str, EngineServerPlugin] = {}
EVENT_SERVER_PLUGINS: dict[str, EventServerPlugin] = {}


def register_engine_server_plugin(plugin: EngineServerPlugin) -> None:
    ENGINE_SERVER_PLUGINS[plugin.name] = plugin


def register_event_server_plugin(plugin: EventServerPlugin) -> None:
    EVENT_SERVER_PLUGINS[plugin.name] = plugin


def engine_plugins(output_type: str) -> list[EngineServerPlugin]:
    return [p for p in ENGINE_SERVER_PLUGINS.values() if p.output_type == output_type]


def event_plugins(input_type: str) -> list[EventServerPlugin]:
    return [p for p in EVENT_SERVER_PLUGINS.values() if p.input_type == input_type]


def apply_output_plugins(engine_instance, query: dict, prediction: Any) -> Any:
    """Blockers fold over the prediction; sniffers observe (CreateServer.scala:573-577)."""
    for plugin in engine_plugins(EngineServerPlugin.OUTPUTBLOCKER):
        prediction = plugin.process(engine_instance, query, prediction, None)
    for plugin in engine_plugins(EngineServerPlugin.OUTPUTSNIFFER):
        try:
            plugin.process(engine_instance, query, prediction, None)
        except Exception:  # noqa: BLE001 - sniffers must not break serving
            logger.exception("outputsniffer %s failed", plugin.name)
    return prediction


def apply_input_plugins(event_json: dict) -> dict:
    """Blockers may reject (raise) or transform; sniffers observe
    (EventServer.scala plugin hooks)."""
    for plugin in event_plugins(EventServerPlugin.INPUTBLOCKER):
        result = plugin.process(event_json, None)
        if isinstance(result, dict):
            event_json = result
    for plugin in event_plugins(EventServerPlugin.INPUTSNIFFER):
        try:
            plugin.process(event_json, None)
        except Exception:  # noqa: BLE001
            logger.exception("inputsniffer %s failed", plugin.name)
    return event_json
