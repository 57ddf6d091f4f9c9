"""Web API tests.

Strategy modeled on the reference's test_api_endpoints.py: aiohttp test
client + a dummy daemon client monkeypatched in (no ZMQ daemon needed),
tmp-path config/EQ dirs via env vars, OPRA fixture database via
OPRA_DATABASE_PATH.
"""

import json

import pytest

pytest_plugins = "aiohttp.pytest_plugin"

from totton_tpu.integration.opra_cache import OpraCacheManager
from totton_tpu.integration.opra_sync import OpraSyncService

from tests.test_opra import SAMPLE_DB  # reuse the fixture database


class DummyResponse:
    def __init__(self, ok=True, data=None, error_code=None, message=None):
        self.ok = ok
        self.data = data or {}
        self.error_code = error_code
        self.message = message


class DummyClient:
    """Stands in for control.client.DaemonClient."""

    phase = "minimum"
    alive = True

    def ping(self):
        return self.alive

    def stats(self):
        return DummyResponse(data={"uptime_ms": 123, "phase_type": self.phase,
                                   "reloads": 0, "soft_resets": 0})

    def reload_config(self):
        return DummyResponse(data={"reloaded": True})

    def soft_reset(self):
        return DummyResponse(data={"reset": True})

    def get_phase_type(self):
        return DummyResponse(data={"phase_type": DummyClient.phase})

    def set_phase_type(self, phase):
        DummyClient.phase = "minimum" if phase == "min" else phase
        return DummyResponse(data={"phase_type": DummyClient.phase})

    def list_devices(self):
        return DummyResponse(data={"playback": [{"id": "null"}],
                                   "capture": [{"id": "null"}]})


@pytest.fixture
def web_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TOTTON_CONFIG_PATH", str(tmp_path / "config.json"))
    monkeypatch.setenv("TOTTON_EQ_DIR", str(tmp_path / "EQ"))
    monkeypatch.setenv("TOTTON_STATS_PATH", str(tmp_path / "stats.json"))
    db_path = tmp_path / "database_v1.jsonl"
    db_path.write_text(SAMPLE_DB)
    monkeypatch.setenv("OPRA_DATABASE_PATH", str(db_path))

    import totton_tpu.integration.opra as opra_mod

    opra_mod.reset_database_cache()

    from totton_tpu.web.services import daemon as daemon_service

    monkeypatch.setattr(daemon_service, "get_client",
                        lambda timeout_ms=1000: DummyClient())
    return tmp_path


@pytest.fixture
async def client(web_env, aiohttp_client):
    from totton_tpu.web.app import create_app

    sync = OpraSyncService(OpraCacheManager(web_env / "cache"))
    return await aiohttp_client(create_app(opra_sync=sync))


VALID_PROFILE = "Preamp: -6 dB\nFilter 1: ON PK Fc 1000 Hz Gain -3 dB Q 1.4\n"


async def test_ui_pages_render(client):
    for path in ("/", "/settings"):
        resp = await client.get(path)
        assert resp.status == 200
        assert "Totton GPU DSP" in await resp.text()


async def test_eq_import_activate_delete_cycle(client):
    # import-text
    resp = await client.post("/api/eq/import-text",
                             json={"name": "myeq", "content": VALID_PROFILE})
    assert resp.status == 200
    body = await resp.json()
    assert body["imported"] == "myeq" and body["filter_count"] == 1

    # listed
    resp = await client.get("/api/eq/profiles")
    profiles = (await resp.json())["profiles"]
    assert [p["name"] for p in profiles] == ["myeq"]
    assert not profiles[0]["active"]

    # activate -> config updated + daemon reloaded
    resp = await client.post("/api/eq/activate/myeq")
    body = await resp.json()
    assert resp.status == 200 and body["reloaded"]

    resp = await client.get("/api/eq/active")
    body = await resp.json()
    assert body["active"] == "myeq"
    assert body["content"]["source_type"] == "custom"

    # cannot delete active
    resp = await client.delete("/api/eq/profiles/myeq")
    assert resp.status == 409

    # deactivate then delete
    assert (await client.post("/api/eq/deactivate")).status == 200
    assert (await client.delete("/api/eq/profiles/myeq")).status == 200
    resp = await client.get("/api/eq/profiles")
    assert (await resp.json())["profiles"] == []


async def test_eq_import_text_rejects_invalid(client):
    resp = await client.post("/api/eq/import-text",
                             json={"name": "bad", "content": "no preamp here"})
    assert resp.status == 400
    body = await resp.json()
    assert any("Preamp" in e for e in body["errors"])

    resp = await client.post("/api/eq/import-text",
                             json={"name": "../evil", "content": VALID_PROFILE})
    assert resp.status == 400


async def test_eq_validate_upload(client):
    import aiohttp

    form = aiohttp.FormData()
    form.add_field("file", VALID_PROFILE.encode(), filename="test.txt")
    resp = await client.post("/api/eq/validate", data=form)
    assert resp.status == 200
    body = await resp.json()
    assert body["valid"] and body["preamp_db"] == -6.0

    form = aiohttp.FormData()
    form.add_field("file", b"x", filename="evil.exe")
    resp = await client.post("/api/eq/validate", data=form)
    assert resp.status == 400


async def test_activate_missing_profile_404(client):
    assert (await client.post("/api/eq/activate/nothere")).status == 404


async def test_opra_browse_and_apply(client, web_env):
    resp = await client.get("/opra/stats")
    assert (await resp.json())["products"] == 3

    resp = await client.get("/opra/search?q=hd650")
    results = (await resp.json())["results"]
    assert results[0]["id"] == "p1"

    resp = await client.get("/opra/eq/e1")
    body = await resp.json()
    assert "Preamp: -6.4 dB" in body["apo_text"]

    # preview with modern target: preamp reduced by 2.8
    resp = await client.get("/opra/eq/e1?modern_target=1")
    body = await resp.json()
    assert "Preamp: -9.2 dB" in body["apo_text"]
    assert "5366" in body["apo_text"]

    # apply writes an attributed profile and activates it
    resp = await client.post("/opra/apply/e1?modern_target=1")
    body = await resp.json()
    assert body["applied"] == "opra_e1_kb5000_7"
    profile_file = web_env / "EQ" / "opra_e1_kb5000_7.txt"
    text = profile_file.read_text()
    assert text.startswith("# OPRA:")
    assert "CC BY-SA 4.0" in text

    resp = await client.get("/api/eq/active")
    body = await resp.json()
    assert body["active"] == "opra_e1_kb5000_7"
    assert body["content"]["source_type"] == "opra"
    assert body["content"]["has_modern_target"]
    assert len(body["content"]["original_filters"]) == 1  # the KB5000_7 band


async def test_opra_missing_ids_404(client):
    assert (await client.get("/opra/product/zzz")).status == 404
    # Reference path shape (plural) resolves to the same handler.
    assert (await client.get("/opra/products/zzz")).status == 404
    assert (await client.get("/opra/eq/zzz")).status == 404
    assert (await client.get("/opra/search")).status == 400


async def test_opra_sync_endpoints(client):
    resp = await client.get("/api/opra/sync/status")
    body = await resp.json()
    assert body["status"] == "idle"
    # rollback with no history is a clean 400
    assert (await client.post("/api/opra/sync/rollback")).status == 400


async def test_status_and_daemon_endpoints(client):
    resp = await client.get("/api/status")
    body = await resp.json()
    assert body["daemon_running"] and body["daemon"]["uptime_ms"] == 123

    resp = await client.get("/api/daemon/phase-type")
    assert (await resp.json())["phase_type"] == "minimum"

    resp = await client.put("/api/daemon/phase-type",
                            json={"phase_type": "linear"})
    assert (await resp.json())["phase_type"] == "linear"

    resp = await client.put("/api/daemon/phase-type",
                            json={"phase_type": "warped"})
    assert resp.status == 400

    assert (await client.post("/api/daemon/reload")).status == 200
    assert (await client.post("/api/daemon/soft-reset")).status == 200
    # restart hook not configured -> 501
    assert (await client.post("/api/daemon/restart")).status == 501

    resp = await client.get("/api/alsa/devices")
    assert "playback" in await resp.json()


async def test_config_get_patch(client, web_env):
    resp = await client.get("/api/config")
    assert await resp.json() == {}

    resp = await client.patch("/api/config", json={
        "filter": {"ratio": 16, "phaseType": "minimum"},
        "alsa": {"sampleRate": 44100},
    })
    assert resp.status == 200
    body = await resp.json()
    assert body["config"]["filter"]["ratio"] == 16

    # nested merge keeps previous keys
    resp = await client.patch("/api/config",
                              json={"alsa": {"channels": 2}})
    body = await resp.json()
    assert body["config"]["alsa"] == {"sampleRate": 44100, "channels": 2}

    cfg = json.loads((web_env / "config.json").read_text())
    assert cfg["filter"]["phaseType"] == "minimum"


async def test_status_includes_serve_stats(client, tmp_path, monkeypatch):
    """When a totton-serve plane runs on the host (its stats file
    exists), /api/status surfaces its aggregate under "serve"."""
    import json

    stats = tmp_path / "serve_stats.json"
    stats.write_text(json.dumps({
        "uptime_ms": 1234,
        "streams": {"active": 3, "accepted": 7, "rejected": 0,
                    "finished": 4},
        "steps": 42, "frames_out": 100000, "per_stream": [],
    }))
    monkeypatch.setenv("TOTTON_SERVE_STATS_PATH", str(stats))
    resp = await client.get("/api/status")
    assert resp.status == 200
    data = await resp.json()
    assert data["serve"]["streams"]["active"] == 3
    assert data["serve"]["steps"] == 42
