"""The port's ``OpenAILLM`` (``urllib``) against the JAX package's (the
``openai`` client), on the CPU with no network: a fake ``openai`` module
records what the JAX package passes to ``chat.completions.create``, and a
recording ``urlopen`` what the port sends.  Both carry the same model,
messages, temperature (or its absence) and response format, and give the
same result for a JSON reply, a non-JSON reply, an empty reply and a
failure.  The port's retries (the client's ``max_retries=2``) run against a
loopback server."""

import email.message
import io
import json
import sys
import types
import urllib.error
import urllib.request
import urllib.response

import pytest
import torch

from fvd_tpu.providers import llm as jllm
from fvd_tpu_torch.providers import llm as tllm
from fvd_tpu_torch.providers import loopback

SYSTEM = "You are a helpful assistant that outputs JSON."
PROMPT = "Extract verifiable factual claims from: the moon landing happened in 1969 — café ünïcode"
IMAGES = [b"\xff\xd8\xff\xe0 a jpeg", b"\x00\x01 another"]
REPLIES = {"json": '{"claims": ["a", "b"], "score": 0.5}', "list": "[1, 2]", "not_json": "I cannot do that",
           "empty": "", "none": None}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def env(monkeypatch):
    for k in ("OPENAI_API_KEY", "OPENAI_BASE_URL", "OPENAI_ORG_ID", "OPENAI_PROJECT_ID"):
        monkeypatch.delenv(k, raising=False)


class FakeOpenAI:
    """What ``openai.OpenAI(api_key=...)`` gives the JAX package: records
    each ``create`` call and answers ``reply`` (or raises ``error``)."""

    calls = []
    reply, error = None, None

    def __init__(self, api_key=None):
        self.api_key = api_key
        self.chat = types.SimpleNamespace(completions=types.SimpleNamespace(create=self.create))

    def create(self, **kwargs):
        FakeOpenAI.calls.append(kwargs)
        if FakeOpenAI.error:
            raise FakeOpenAI.error
        message = types.SimpleNamespace(content=FakeOpenAI.reply)
        return types.SimpleNamespace(choices=[types.SimpleNamespace(message=message)])


@pytest.fixture
def both(monkeypatch):
    """-> (JAX LLM, port LLM, port's captured requests), both keyed, with
    ``reply(content)`` / ``fail(exc)`` setting what each backend answers."""
    monkeypatch.setitem(sys.modules, "openai", types.SimpleNamespace(OpenAI=FakeOpenAI))
    FakeOpenAI.calls, FakeOpenAI.reply, FakeOpenAI.error = [], None, None
    sent, answer = [], {"content": None, "error": None}

    def urlopen(req, timeout=None):
        sent.append((req, timeout))
        if answer["error"]:
            raise answer["error"]
        body = json.dumps({"choices": [{"index": 0, "message": {"role": "assistant", "content": answer["content"]}}]})
        headers = email.message.Message()
        headers["Content-Type"] = "application/json"
        return urllib.response.addinfourl(io.BytesIO(body.encode()), headers, req.full_url, 200)

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)

    def reply(content):
        FakeOpenAI.reply = answer["content"] = content

    def fail(jax_exc, port_exc):
        FakeOpenAI.error, answer["error"] = jax_exc, port_exc

    return jllm.OpenAILLM(api_key="sk-test"), tllm.OpenAILLM(api_key="sk-test"), sent, reply, fail


def _body(req):
    return json.loads(req.data.decode())


@pytest.mark.parametrize("kind", ["chat", "vision"])
def test_request_carries_what_the_client_sends(both, kind):
    j, t, sent, reply, _ = both
    reply(REPLIES["json"])
    call = (lambda llm: llm.chat_json(SYSTEM, PROMPT)) if kind == "chat" else \
        (lambda llm: llm.vision_json(SYSTEM, PROMPT, IMAGES))
    assert call(t) == call(j) == json.loads(REPLIES["json"])
    want, = FakeOpenAI.calls
    (req, timeout), = sent
    body = _body(req)
    for key in ("model", "messages", "response_format"):
        assert body[key] == want[key], key
    assert body["model"] == "gpt-4o" and body["response_format"] == {"type": "json_object"}
    assert ("temperature" in body) == ("temperature" in want) == (kind == "chat")
    if kind == "chat":
        assert body["temperature"] == want["temperature"] == 0.1
    else:
        parts = body["messages"][1]["content"]
        assert parts[1]["image_url"]["url"].startswith("data:image/jpeg;base64,")
    assert set(body) - {"temperature"} == {"model", "messages", "response_format"}
    assert timeout == want["timeout"] == 30.0
    assert req.full_url == "https://api.openai.com/v1/chat/completions" and req.get_method() == "POST"
    assert req.get_header("Authorization") == "Bearer sk-test"
    assert req.get_header("Content-type") == "application/json"


@pytest.mark.parametrize("reply_kind", REPLIES)
@pytest.mark.parametrize("kind", ["chat", "vision"])
def test_replies_give_the_same_result(both, kind, reply_kind):
    j, t, _, reply, _ = both
    reply(REPLIES[reply_kind])
    call = (lambda llm: llm.chat_json(SYSTEM, PROMPT)) if kind == "chat" else \
        (lambda llm: llm.vision_json(SYSTEM, PROMPT, IMAGES))
    assert call(t) == call(j)


@pytest.mark.parametrize("kind", ["chat", "vision"])
def test_a_failure_gives_none(both, kind):
    j, t, sent, _, fail = both
    fail(RuntimeError("invalid api key"),
         urllib.error.HTTPError("https://api.openai.com/v1/chat/completions", 401, "Unauthorized",
                                email.message.Message(), io.BytesIO(b"{}")))
    call = (lambda llm: llm.chat_json(SYSTEM, PROMPT)) if kind == "chat" else \
        (lambda llm: llm.vision_json(SYSTEM, PROMPT, IMAGES))
    assert call(t) is None and call(j) is None
    assert len(sent) == 1  # a 401 is not retried


def test_without_a_key_nothing_is_sent(monkeypatch):
    monkeypatch.setattr(urllib.request, "urlopen", lambda *a, **k: pytest.fail("sent a request"))
    monkeypatch.setitem(sys.modules, "openai", types.SimpleNamespace(OpenAI=FakeOpenAI))
    t, j = tllm.OpenAILLM(), jllm.OpenAILLM()
    assert t.available is j.available is False
    assert t.chat_json(SYSTEM, PROMPT) is None and t.vision_json(SYSTEM, PROMPT, IMAGES) is None


def test_key_and_base_url_come_from_the_environment(monkeypatch):
    monkeypatch.setenv("OPENAI_API_KEY", "sk-env")
    monkeypatch.setenv("OPENAI_BASE_URL", "http://127.0.0.1:9/v1/")
    monkeypatch.setenv("OPENAI_ORG_ID", "org-1")
    t = tllm.OpenAILLM()
    assert t.available
    req = t.request({"model": "gpt-4o"})
    assert req.full_url == "http://127.0.0.1:9/v1/chat/completions"
    assert req.get_header("Authorization") == "Bearer sk-env" and req.get_header("Openai-organization") == "org-1"


def test_retries_twice_on_a_server_error_over_loopback(monkeypatch):
    """Two 500s then a reply: three requests and the reply; three 500s give
    None; a 400 is not retried; a 429's Retry-After is slept."""
    slept = []
    monkeypatch.setattr(tllm.time, "sleep", slept.append)
    with loopback.LoopbackServices() as svc, svc.pointed():
        llm = tllm.OpenAILLM()
        svc.chat_failures[:] = [500, 502]
        assert llm.chat_json(SYSTEM, "Extract verifiable factual claims") == {"claims": loopback.CLAIMS}
        assert svc.counts()["/v1/chat/completions"] == 3 and len(slept) == 2
        assert 0.375 <= slept[0] <= 0.5 and 0.75 <= slept[1] <= 1.0
        svc.chat_failures[:] = [500, 500, 500]
        assert llm.chat_json(SYSTEM, "x") is None
        assert svc.counts()["/v1/chat/completions"] == 6
        svc.chat_failures[:] = [400]
        assert llm.chat_json(SYSTEM, "x") is None
        assert svc.counts()["/v1/chat/completions"] == 7
        assert llm.vision_json("forensic image analyst", "look", IMAGES) == loopback.LLM_RESPONSES[
            "forensic image analyst"]
        assert llm.chat_json(SYSTEM, "nothing scripted") is None  # content null
        method, path, headers, body = svc.requests[-2]
        assert headers["Authorization"] == "Bearer loopback-key" and "temperature" not in body


def test_retry_after_is_honoured(monkeypatch):
    slept = []
    monkeypatch.setattr(tllm.time, "sleep", slept.append)
    headers = email.message.Message()
    headers["Retry-After"] = "2"
    errors = [urllib.error.HTTPError("u", 429, "Too Many", headers, io.BytesIO(b""))]

    def urlopen(req, timeout=None):
        if errors:
            raise errors.pop()
        body = json.dumps({"choices": [{"message": {"content": '{"ok": 1}'}}]}).encode()
        return urllib.response.addinfourl(io.BytesIO(body), email.message.Message(), req.full_url, 200)

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    assert tllm.OpenAILLM(api_key="k").chat_json(SYSTEM, PROMPT) == {"ok": 1}
    assert slept == [2.0]
