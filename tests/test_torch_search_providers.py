"""The port's networked search (``fvd_tpu_torch/providers/search.py``) and
the factory's LLM and search seams against the JAX package's, on the CPU
with no network: the JAX package's four search cases run through both
packages; Serper, Google CSE and DuckDuckGo build the same requests and
parse the same fixed payloads into the same results (``requests`` and
``urlopen`` replaced by recorders); the disk cache's files are hits for the
other package; an HTTP error status and a refused connection fall through
the chain on a loopback server; and ``network_services`` picks the kinds the
JAX package's ``production_providers`` picks for each setting."""

import email.message
import io
import json
import socket
import sys
import types
import urllib.error
import urllib.request
import urllib.response

import pytest
import requests
import torch

from fvd_tpu.models import face_ssd as jface_ssd
from fvd_tpu.models import landmarks_fan as jlandmarks
from fvd_tpu.providers import factory as jfactory
from fvd_tpu.providers import search as jsearch
from fvd_tpu_torch.providers import factory, loopback
from fvd_tpu_torch.providers import search as tsearch

PACKAGES = {"jax": jsearch, "port": tsearch}
KEYS = ("OPENAI_API_KEY", "OPENAI_BASE_URL", "SERPER_API_KEY", "GOOGLE_API_KEY", "GOOGLE_CX",
        "FVD_SEARCH_CACHE_DIR")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_keys(monkeypatch):
    """No key, base URL or cache directory from the environment: a test
    sets what it needs."""
    for k in KEYS:
        monkeypatch.delenv(k, raising=False)


# --------------------------------------------- the JAX package's four cases
@pytest.mark.parametrize("pkg", PACKAGES)
def test_ddg_parse_unwraps_redirects_and_snippets(pkg):
    from test_search_providers import DDG_HTML

    results = PACKAGES[pkg].DuckDuckGoSearch.parse_html(DDG_HTML)
    assert len(results) == 2
    assert results[0]["url"] == "https://example.com/fact-check"
    assert results[0]["title"] == "Moon landing fact check"
    assert "verified by experts" in results[0]["snippet"]
    assert results[0]["source"] == "duckduckgo"
    assert results[1]["url"] == "https://news.example.org/story"
    assert results[1]["snippet"] == ""
    assert results == jsearch.DuckDuckGoSearch.parse_html(DDG_HTML)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_ddg_sits_last_in_fallback_chain(pkg, monkeypatch):
    s = PACKAGES[pkg]
    ddg = s.DuckDuckGoSearch()
    monkeypatch.setattr(ddg, "search", lambda q, max_results=5: [s.make_result("https://d.dg/x", "hit")])
    out = s.ChainSearch([s.FailingSearch(), s.FailingSearch(), ddg]).search("anything")
    assert out and out[0]["url"] == "https://d.dg/x"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_cached_search_hits_disk_not_backend(pkg, tmp_path):
    s = PACKAGES[pkg]
    backend = s.StaticSearch({"cats": [s.make_result("https://a/", "A")]})
    cached = s.CachedSearch(backend, str(tmp_path))
    assert cached.search("cats on mars")[0]["url"] == "https://a/"
    assert len(backend.queries) == 1
    assert cached.search("cats on mars")[0]["url"] == "https://a/"
    assert len(backend.queries) == 1
    other = s.CachedSearch(s.StaticSearch({}), str(tmp_path))
    assert other.search("cats on mars")[0]["url"] == "https://a/"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_cached_search_expires_and_skips_empty(pkg, tmp_path):
    s = PACKAGES[pkg]
    backend = s.StaticSearch({"q1": [s.make_result("https://b/", "B")]})
    cached = s.CachedSearch(backend, str(tmp_path), ttl_s=0.0)
    cached.search("q1")
    cached.search("q1")
    assert len(backend.queries) == 2
    cached.search("nohit")
    assert not [p for p in tmp_path.iterdir() if "tmp" in p.name]
    for p in tmp_path.iterdir():
        assert json.loads(p.read_text())["results"], "cache must not store empty result sets"


# ------------------------------------------- requests and payloads, fixed
class _Recorder:
    """``requests.get``/``post`` for the JAX package and ``urlopen`` for the
    port: each records what it was asked and answers ``body``."""

    def __init__(self, body: str, content_type: str):
        self.body, self.content_type, self.calls = body, content_type, []

    def requests_call(self, method):
        def call(url, timeout=None, **kw):
            prepared = requests.Request(method, url, headers=kw.get("headers"), data=kw.get("data"),
                                        params=kw.get("params")).prepare()
            self.calls.append((prepared, timeout))
            resp = requests.Response()
            resp.status_code, resp._content, resp.url = 200, self.body.encode(), prepared.url
            resp.headers["Content-Type"] = self.content_type
            return resp
        return call

    def urlopen(self, req, timeout=None):
        self.calls.append((req, timeout))
        headers = email.message.Message()
        headers["Content-Type"] = self.content_type
        return urllib.response.addinfourl(io.BytesIO(self.body.encode()), headers, req.full_url, 200)


def _jax_request(prepared):
    """(method, url, headers the code set, body bytes) of a prepared
    ``requests`` request: requests' own defaults left out."""
    defaults = {"accept-encoding", "accept", "connection", "content-length"}
    headers = {k.lower(): v for k, v in prepared.headers.items()
               if k.lower() not in defaults and not (k.lower() == "user-agent" and v.startswith("python-requests"))}
    body = prepared.body.encode() if isinstance(prepared.body, str) else prepared.body
    return prepared.method, prepared.url, headers, body


def _port_request(req):
    return req.get_method(), req.full_url, {k.lower(): v for k, v in req.header_items()}, req.data


BACKENDS = {
    "serper": (lambda s: s.SerperSearch(api_key="k-serper"), json.dumps(loopback.SERPER_PAYLOAD),
               "application/json", "post"),
    "google": (lambda s: s.GoogleCSESearch(api_key="k-google", cx="c x"), json.dumps(loopback.CSE_PAYLOAD),
               "application/json; charset=UTF-8", "get"),
    "duckduckgo": (lambda s: s.DuckDuckGoSearch(), loopback.DDG_HTML, "text/html; charset=utf-8", "post"),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("query,max_results", [("the moon landing happened in 1969 fact check", 5),
                                               ("is it true that café prices & taxes rose 10%?", 2)])
def test_backend_request_and_results_match_jax(backend, query, max_results, monkeypatch):
    make, body, content_type, method = BACKENDS[backend]
    jrec, trec = _Recorder(body, content_type), _Recorder(body, content_type)
    monkeypatch.setattr(requests, method, jrec.requests_call(method.upper()))
    monkeypatch.setattr(urllib.request, "urlopen", trec.urlopen)
    want = make(jsearch).search(query, max_results)
    got = make(tsearch).search(query, max_results)
    assert got == want and len(got) == {"serper": 3, "google": 2, "duckduckgo": 2}[backend]
    (jreq, jtimeout), = jrec.calls
    (treq, ttimeout), = trec.calls
    assert _port_request(treq) == _jax_request(jreq)
    assert ttimeout == jtimeout == (8 if backend == "duckduckgo" else 5)


@pytest.mark.parametrize("backend", ["serper", "google"])
def test_keyless_backends_send_nothing(backend, monkeypatch):
    calls = []
    monkeypatch.setattr(urllib.request, "urlopen", lambda *a, **k: calls.append(a))
    make = {"serper": lambda s: s.SerperSearch(), "google": lambda s: s.GoogleCSESearch(api_key="k")}[backend]
    assert make(tsearch).search("q") == make(jsearch).search("q") == [] and not calls


@pytest.mark.parametrize("writer,reader", [(jsearch, tsearch), (tsearch, jsearch)])
def test_cache_files_are_hits_for_the_other_package(writer, reader, tmp_path):
    results = [writer.make_result("https://a/", "A", "snippet", "serper", "2024")]
    w = writer.CachedSearch(writer.StaticSearch({"q": results}), str(tmp_path))
    assert w.search("the q", 3) == results
    backend = reader.StaticSearch({})
    r = reader.CachedSearch(backend, str(tmp_path))
    assert r.search("the q", 3) == results and backend.queries == []
    assert r._path("the q", 3) == w._path("the q", 3)
    assert r.search("the q", 4) == [] and backend.queries == ["the q"]  # max_results is in the key


# --------------------------------------------------- loopback, no network
def _closed_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_without_keys_the_chain_is_empty_when_duckduckgo_is_unreachable(monkeypatch):
    """No keys: Serper and CSE send nothing, DuckDuckGo's connection is
    refused (a closed loopback port), and the chain returns []."""
    monkeypatch.setattr(tsearch.DuckDuckGoSearch, "ENDPOINT", f"http://127.0.0.1:{_closed_port()}/html/")
    monkeypatch.setenv("NO_PROXY", "127.0.0.1")
    chain = tsearch.default_chain()
    assert tsearch.describe(chain) == "ChainSearch(SerperSearch, GoogleCSESearch, DuckDuckGoSearch)"
    with pytest.raises(OSError):
        chain.providers[2].search("q")
    assert chain.search("the moon landing") == []


def test_chain_falls_through_an_error_status_on_loopback(tmp_path, monkeypatch):
    """Serper answers 500 (raises, as ``raise_for_status`` does), CSE has no
    items, DuckDuckGo answers: the chain returns DuckDuckGo's results, and
    the cache then answers without a request."""
    monkeypatch.setenv("FVD_SEARCH_CACHE_DIR", str(tmp_path))
    with loopback.LoopbackServices() as svc, svc.pointed():
        with pytest.raises(urllib.error.HTTPError) as err:
            tsearch.SerperSearch().search("the eiffel tower")
        assert err.value.code == 500
        chain = tsearch.default_chain()
        assert tsearch.describe(chain).startswith("CachedSearch(ChainSearch(")
        assert chain.search("the eiffel tower is in paris hoax") == loopback.DDG_RESULTS
        assert chain.search("the moon landing happened in 1969 fake") == loopback.SERPER_RESULTS
        assert chain.search("water boils at 100 degrees fake") == loopback.CSE_RESULTS
        before = len(svc.requests)
        assert chain.search("the eiffel tower is in paris hoax") == loopback.DDG_RESULTS
        assert len(svc.requests) == before
    assert svc.counts() == {"/serper/search": 4, "/customsearch/v1": 2, "/html/": 1}


# ------------------------------------------- the factory's LLM and search
def _kinds(search) -> str:
    """A search provider's classes, chain and cache included, by name (the
    two packages' classes are distinct)."""
    name = type(search).__name__
    if name == "CachedSearch":
        return f"CachedSearch({_kinds(search.backend)})"
    if name == "ChainSearch":
        return f"ChainSearch({', '.join(_kinds(p) for p in search.providers)})"
    return name


@pytest.fixture
def fake_openai(monkeypatch):
    """An ``openai`` module, so that the JAX package's ``OpenAILLM`` has a
    client where a key is set (the package is not installed here)."""
    mod = types.ModuleType("openai")
    mod.OpenAI = lambda api_key=None: types.SimpleNamespace(api_key=api_key)
    monkeypatch.setitem(sys.modules, "openai", mod)


@pytest.fixture
def jax_services(monkeypatch):
    """The JAX package's ``production_providers`` with its vision models and
    OCR stubbed out: -> (llm, search) for its arguments."""
    monkeypatch.setattr(jface_ssd, "SSDFaceDetector", lambda **kw: None)
    monkeypatch.setattr(jlandmarks, "FANLandmarks", lambda *a, **kw: None)
    monkeypatch.setattr(jfactory, "_build_ocr", lambda *a: None)

    def services(tmp, **kw):
        p = jfactory.production_providers(str(tmp / "none"), **kw)
        return p.llm, p.search
    return services


SETTINGS = [dict(use_llm=u, use_search=s) for u in (True, False) for s in (True, False)] + [
    dict(recorded_services=True), dict(use_llm=False, use_search=False, recorded_services=True)]


@pytest.mark.parametrize("key", [None, "sk-test"])
@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("setting", SETTINGS, ids=lambda s: ",".join(f"{k}={v}" for k, v in s.items()))
def test_factory_services_match_jax(setting, key, cache, fake_openai, jax_services, tmp_path, monkeypatch):
    if key:
        monkeypatch.setenv("OPENAI_API_KEY", key)
    if cache:
        monkeypatch.setenv("FVD_SEARCH_CACHE_DIR", str(tmp_path / "cache"))
    jllm, jsearch_ = jax_services(tmp_path, **setting)
    tllm, tsearch_ = factory.network_services(**setting)
    assert type(tllm).__name__ == type(jllm).__name__
    assert tllm.available == jllm.available
    assert _kinds(tsearch_) == _kinds(jsearch_)
    if setting.get("recorded_services"):
        assert type(tllm).__name__ == "RecordedLLM"
    elif setting["use_llm"] and key:
        assert type(tllm).__name__ == "OpenAILLM" and tllm.api_key == key
    else:
        assert type(tllm).__name__ == "NullLLM"


def test_bootstrap_production_passes_the_seams_on(monkeypatch):
    seen = {}
    monkeypatch.setattr(factory, "production_providers", lambda ckpt, **kw: seen.update(kw) or "bundle")
    import fvd_tpu_torch.providers as tprov

    monkeypatch.setattr(tprov, "_default", tprov.Providers())
    monkeypatch.setattr(tprov, "_default_is_custom", False)
    assert factory.bootstrap_production(use_llm=False, use_search=True, device="cpu") == "bundle"
    assert seen == {"use_llm": False, "use_search": True, "device": "cpu"}
