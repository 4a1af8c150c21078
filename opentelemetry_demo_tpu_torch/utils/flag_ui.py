"""Flag editor: the flagd-ui analogue, as one handler object.

The shop's flag editor rewrites the flagd JSON file that its services
evaluate: a "basic" page that sets each flag's ``defaultVariant``, an
"advanced" raw-JSON editor, and two API routes doing the file IO
(``/api/read-file``, ``/api/write-to-file``). :class:`FlagEditorUI` is
that surface; a gateway mounts it at ``/feature`` and passes it the path
below the mount.

It works against either store:

- :class:`~.flags.FlagFileStore`: a write replaces the JSON file
  atomically, and every process reading the file reloads it;
- a plain :class:`~.flags.FlagEvaluator`: a write replaces the
  in-memory document.

The routes, pages and verdicts are the JAX package's ``flag_ui``'s.
"""

from __future__ import annotations

import json
from html import escape

from .flags import FlagEvaluator, FlagFileStore, atomic_write_doc


class FlagValidationError(ValueError):
    pass


def validate_flag_doc(doc) -> dict:
    """Schema-check a flagd document the way flagd-ui's save path does."""
    if not isinstance(doc, dict) or not isinstance(doc.get("flags"), dict):
        raise FlagValidationError('document must be {"flags": {...}}')
    for key, flag in doc["flags"].items():
        if not isinstance(flag, dict):
            raise FlagValidationError(f"flag {key!r} must be an object")
        variants = flag.get("variants")
        if not isinstance(variants, dict) or not variants:
            raise FlagValidationError(f"flag {key!r} needs non-empty variants")
        default = flag.get("defaultVariant")
        if default not in variants:
            raise FlagValidationError(
                f"flag {key!r}: defaultVariant {default!r} not in variants"
            )
        if flag.get("state") not in ("ENABLED", "DISABLED"):
            raise FlagValidationError(f"flag {key!r}: state must be ENABLED|DISABLED")
    return doc


class FlagEditorUI:
    """handle(method, path, body) -> (status, content_type, bytes)."""

    def __init__(self, store: FlagEvaluator):
        self.store = store

    # -- store IO ------------------------------------------------------

    def _read_doc(self) -> dict:
        if isinstance(self.store, FlagFileStore):
            with open(self.store.path) as f:
                return json.load(f)
        # Deep copy: handlers mutate the returned doc before validation,
        # and a rejected write must never corrupt the live store.
        return self.store.snapshot()

    def _write_doc(self, doc: dict) -> None:
        validate_flag_doc(doc)
        if isinstance(self.store, FlagFileStore):
            # Atomic replace (flags.atomic_write_doc, the one flag-file
            # write primitive): readers hot-reload on mtime and must
            # never observe a torn write.
            atomic_write_doc(self.store.path, doc)
            self.store._maybe_reload(force=True)
        else:
            self.store.replace(doc)

    # -- routing -------------------------------------------------------

    def handle(self, method: str, path: str, body: bytes):
        try:
            if path in ("/", "") and method == "GET":
                return 200, "text/html", self._page_basic()
            if path == "/advanced" and method == "GET":
                return 200, "text/html", self._page_advanced()
            if path == "/api/read-file" and method == "GET":
                return 200, "application/json", json.dumps(self._read_doc()).encode()
            if path == "/api/write-to-file" and method == "POST":
                payload = json.loads(body or b"{}")
                self._write_doc(payload.get("data", payload))
                return 200, "application/json", b'{"status":"saved"}'
            if path == "/api/set-variant" and method == "POST":
                # Basic-page action: flip one flag's defaultVariant.
                req = json.loads(body or b"{}")
                doc = self._read_doc()
                flag = doc.get("flags", {}).get(req.get("flag"))
                if flag is None:
                    return 404, "application/json", b'{"error":"no such flag"}'
                flag["defaultVariant"] = req.get("variant")
                self._write_doc(doc)
                return 200, "application/json", b'{"status":"saved"}'
            return 404, "text/plain", b"no route"
        except (FlagValidationError, json.JSONDecodeError) as e:
            return 400, "application/json", json.dumps({"error": str(e)}).encode()

    # -- pages ---------------------------------------------------------

    def _page_basic(self) -> bytes:
        doc = self._read_doc()
        rows = []
        for key, flag in sorted(doc.get("flags", {}).items()):
            opts = "".join(
                f'<option value="{escape(str(v))}"'
                f'{" selected" if v == flag.get("defaultVariant") else ""}>'
                f"{escape(str(v))}</option>"
                for v in flag.get("variants", {})
            )
            rows.append(
                f"<tr><td><code>{escape(key)}</code></td>"
                f"<td>{escape(flag.get('state', ''))}</td>"
                f'<td><select onchange="setVariant(\'{escape(key)}\', this.value)">'
                f"{opts}</select></td></tr>"
            )
        return (
            "<!doctype html><title>Flags</title>"
            "<h1>Feature Flags</h1>"
            '<p><a href="/feature/advanced">advanced (raw JSON)</a></p>'
            "<table border=1 cellpadding=4><tr><th>flag</th><th>state</th>"
            "<th>defaultVariant</th></tr>" + "".join(rows) + "</table>"
            "<script>function setVariant(flag, variant) {"
            "fetch('/feature/api/set-variant', {method: 'POST',"
            "headers: {'Content-Type': 'application/json'},"
            "body: JSON.stringify({flag, variant})}).then(() => location.reload());"
            "}</script>"
        ).encode()

    def _page_advanced(self) -> bytes:
        raw = json.dumps(self._read_doc(), indent=2)
        return (
            "<!doctype html><title>Flags (advanced)</title>"
            "<h1>Raw flag JSON</h1>"
            f'<textarea id="doc" rows="30" cols="100">{escape(raw)}</textarea><br>'
            '<button onclick="save()">Save</button> <span id="msg"></span>'
            "<script>function save() {"
            "fetch('/feature/api/write-to-file', {method: 'POST',"
            "headers: {'Content-Type': 'application/json'},"
            "body: JSON.stringify({data: JSON.parse("
            "document.getElementById('doc').value)})})"
            ".then(r => r.json()).then(d => {"
            "document.getElementById('msg').textContent = "
            "d.status || d.error;});}</script>"
        ).encode()
