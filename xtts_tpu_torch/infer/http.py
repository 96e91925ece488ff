"""HTTP synthesis server over BatchServer or the slot pool (port of
xtts_tpu/infer/http.py).

Requests are split into sentences and each sentence is submitted to the
shared backend, so concurrent requests share its device work: waves packed
within window_ms (BatchServer) or the continuously refilled slot pool
(slots.ContinuousBatcher, --continuous).

API:
  GET  /healthz            -> {"ok": true, "pending": N}
  GET  /metrics            -> the backend's stats()
  POST /tts                -> audio/wav (16-bit PCM, 24 kHz)
      {"text": "你好，世界。", "lang": "ZH",
       "voice_path": "/path/ref.wav"}   # optional per-request voice
                                        # (a file on the server, cached)
  400 malformed request, 404 unknown path, 500 pipeline error, 503 queue
  full (max_pending), 504 queued past the request timeout.

Run on the card (random weights; --model-dir loads TextToSpeech
.from_pretrained):
  python -m xtts_tpu_torch.infer.http --ref-wav ref.wav --port 8080 \\
      [--continuous] [--diffusion]
Try:
  curl -s localhost:8080/tts -d '{"text":"你好，世界。"}' -o out.wav
"""
import argparse
import io
import json
import threading
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    """float32 [-1, 1] -> 16-bit PCM RIFF/WAV bytes (stdlib only)."""
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


class SynthesisService:
    """Tokenize -> submit sentences to the backend -> concatenated wav.

    One service a process (one process holds the card). Thread-safe:
    handler threads tokenize, compute per-request voice mels and wait on
    futures; the decode and the render run on the backend's worker thread.
    """

    MAX_VOICES = 64   # bound of the per-path conditioning-mel cache

    def __init__(self, tts, cond_wav: np.ndarray, settings=None,
                 max_batch: int = 8, window_ms: float = 20.0,
                 use_diffusion: bool = False, use_hifigan: bool = False,
                 batch_buckets=None, backend: str = "waves",
                 max_pending=None, request_timeout_s=None):
        """backend: 'waves' packs arrivals into fixed-batch waves
        (BatchServer); 'slots' runs a pool of max_batch decode slots
        refilled mid-stream (slots.ContinuousBatcher; quantized_decode=True,
        no HiFi-GAN render).

        max_pending / request_timeout_s: backpressure, passed to the
        backend: a full queue rejects new sentences (ServerBusy -> 503) and
        a sentence queued longer than the timeout fails (-> 504)."""
        from xtts_tpu_torch.infer.api import TTSSettings
        from xtts_tpu_torch.infer.serving import BatchServer

        self.tts = tts
        self.settings = settings or TTSSettings()
        self.sample_rate = tts.cfg.mel.sample_rate
        cond_mel = tts.cond_mel_bucketed(np.asarray(cond_wav, np.float32))
        if backend == "slots":
            from xtts_tpu_torch.infer.slots import ContinuousBatcher
            if use_hifigan:
                raise ValueError("backend='slots' renders through the DVAE "
                                 "or the diffusion only (use waves for "
                                 "HiFi-GAN)")
            self.server = ContinuousBatcher(
                tts, cond_mel, self.settings, n_slots=max_batch,
                use_diffusion=use_diffusion, max_pending=max_pending,
                request_timeout_s=request_timeout_s)
        elif backend == "waves":
            spk = tts.speaker_mel_from_wav(cond_wav) if use_hifigan else None
            self.server = BatchServer(
                tts, cond_mel, self.settings, max_batch=max_batch,
                window_ms=window_ms, use_diffusion=use_diffusion,
                use_hifigan=use_hifigan, spk_mel16=spk,
                batch_buckets=batch_buckets, max_pending=max_pending,
                request_timeout_s=request_timeout_s)
        else:
            raise ValueError(f"unknown backend {backend!r}")
        self._voice_cache: dict = {}
        self._voice_lock = threading.Lock()

    def warmup(self, **kw) -> int:
        """The backend's warmup: BatchServer's (batch bucket x text bucket)
        waves or ContinuousBatcher's installs, segments and render rungs."""
        return self.server.warmup(**kw)

    def _voice(self, path):
        if path is None:
            return None
        with self._voice_lock:
            if path in self._voice_cache:
                return self._voice_cache[path]
        # computed outside the lock, so a first use never blocks requests
        # on cached voices (two racing first uses compute it twice)
        from xtts_tpu_torch.data.audio import load_wav
        wav, _ = load_wav(path, self.sample_rate)
        mel = self.tts.cond_mel_bucketed(wav)
        with self._voice_lock:
            if len(self._voice_cache) >= self.MAX_VOICES:
                self._voice_cache.pop(next(iter(self._voice_cache)))
            self._voice_cache[path] = mel
        return mel

    def synthesize(self, text: str, lang: str = "ZH",
                   voice_path=None) -> np.ndarray:
        token_lists = self.tts._text_to_token_lists(text, lang, self.settings)
        if not token_lists:
            return np.zeros((0,), np.float32)
        cond = self._voice(voice_path)
        futures = [self.server.submit(t, cond_mel=cond) for t in token_lists]
        return np.concatenate([np.asarray(f.result()).reshape(-1)
                               for f in futures])

    def close(self):
        self.server.close()


def make_handler(svc: SynthesisService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True,
                                 "pending": svc.server.pending()})
            elif self.path == "/metrics":
                self._json(200, svc.server.stats())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/tts":
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(req, dict):
                    raise TypeError("body must be a JSON object")
                text = req["text"]
            except (KeyError, ValueError, TypeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            try:
                wav = svc.synthesize(text, req.get("lang", "ZH"),
                                     req.get("voice_path"))
            except Exception as e:
                from xtts_tpu_torch.infer.serving import ServerBusy
                if isinstance(e, ServerBusy):
                    code = 503          # backpressure: retry later
                elif isinstance(e, TimeoutError):
                    code = 504          # queued past request_timeout_s
                else:
                    code = 500          # device or pipeline error
                self._json(code, {"error": str(e)})
                return
            body = wav_bytes(wav, svc.sample_rate)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def serve(svc: SynthesisService, host: str, port: int) -> ThreadingHTTPServer:
    """Serve on a daemon thread; port 0 picks a free one
    (httpd.server_address). Stop with httpd.shutdown()."""
    httpd = ThreadingHTTPServer((host, port), make_handler(svc))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ref-wav", required=True, help="default voice (24k wav)")
    ap.add_argument("--model-dir", default=None,
                    help="checkpoints for TextToSpeech.from_pretrained "
                         "(<name>.pth / .npz); default random weights")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--window-ms", type=float, default=20.0)
    ap.add_argument("--diffusion", action="store_true",
                    help="full-quality 50-step CFG render (default: the DVAE "
                         "shortcut)")
    ap.add_argument("--hifigan", action="store_true",
                    help="HifiDecoder latent->wav render")
    ap.add_argument("--batch-buckets", default="1,2,4,8",
                    help="comma-separated row-count buckets of the waves "
                         "('' = one shape per arrival count)")
    ap.add_argument("--continuous", action="store_true",
                    help="slot-serving backend: a pool of --max-batch decode "
                         "slots refilled mid-stream instead of waves")
    ap.add_argument("--max-pending", type=int, default=256,
                    help="queue-depth bound: submissions beyond this many "
                         "pending sentences get 503 (0 = unbounded)")
    ap.add_argument("--request-timeout", type=float, default=120.0,
                    help="seconds a sentence may wait queued before it "
                         "fails with 504 (0 = no timeout)")
    ap.add_argument("--warmup", action="store_true",
                    help="drive the serving grid before accepting traffic")
    args = ap.parse_args(argv)

    import torch

    from xtts_tpu_torch.data.audio import load_wav
    from xtts_tpu_torch.infer.api import TextToSpeech

    kw = dict(dtype=torch.bfloat16, quantized_decode=True,
              with_hifigan=args.hifigan)          # on the card
    if args.model_dir:
        tts = TextToSpeech.from_pretrained(args.model_dir, **kw)
    else:
        tts = TextToSpeech(**kw)
    cond, _ = load_wav(args.ref_wav, tts.cfg.mel.sample_rate)
    buckets = tuple(int(x) for x in args.batch_buckets.split(",") if x) or None
    svc = SynthesisService(tts, cond, max_batch=args.max_batch,
                           window_ms=args.window_ms,
                           use_diffusion=args.diffusion,
                           use_hifigan=args.hifigan, batch_buckets=buckets,
                           backend="slots" if args.continuous else "waves",
                           max_pending=args.max_pending or None,
                           request_timeout_s=args.request_timeout or None)
    if args.warmup:
        print("warming up the serving grid ...", flush=True)
        print(f"warmup done ({svc.warmup()} requests)", flush=True)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(svc))
    print(f"serving on http://{args.host}:{args.port}  "
          f"(POST /tts, GET /healthz, GET /metrics)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        svc.close()


if __name__ == "__main__":
    main()
