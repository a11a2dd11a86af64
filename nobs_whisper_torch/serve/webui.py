"""Built-in web client (the L7 settings-SPA analog).

The reference ships a Svelte settings UI (src/routes/+page.svelte): model
picker grouped by category with streaming download progress polled every
500 ms (+page.svelte:106-119,352-443), config editing written through on
change (:158-167), and live recording state. This single static page
serves the same capability against the HTTP API — model management,
config form, and a live session panel driven over SSE — with no build
step and no external assets (a serving host may have no egress; everything
inline).

Served by serve/server.py at GET /. Port of the JAX package's
``serve/webui.py``; the page names the port.
"""

INDEX_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>nobs-whisper-torch</title>
<style>
  :root {
    --bg: #f6f6f4; --fg: #1a1a1a; --card: #ffffff; --muted: #6b6b6b;
    --accent: #2563eb; --ok: #16a34a; --warn: #d97706; --err: #dc2626;
    --border: #e2e2de;
  }
  @media (prefers-color-scheme: dark) {
    :root {
      --bg: #111114; --fg: #ececec; --card: #1c1c21; --muted: #9a9aa2;
      --accent: #60a5fa; --ok: #4ade80; --warn: #fbbf24; --err: #f87171;
      --border: #2a2a31;
    }
  }
  * { box-sizing: border-box; }
  body { margin: 0; background: var(--bg); color: var(--fg);
         font: 14px/1.5 system-ui, sans-serif; }
  main { max-width: 760px; margin: 0 auto; padding: 24px 16px 64px; }
  h1 { font-size: 20px; } h2 { font-size: 15px; margin: 24px 0 8px; }
  .card { background: var(--card); border: 1px solid var(--border);
          border-radius: 10px; padding: 14px 16px; margin-bottom: 10px; }
  .row { display: flex; align-items: center; gap: 10px; }
  .row .grow { flex: 1; }
  .muted { color: var(--muted); font-size: 12px; }
  button { background: var(--accent); color: #fff; border: 0;
           border-radius: 7px; padding: 6px 12px; cursor: pointer;
           font: inherit; }
  button.ghost { background: transparent; color: var(--accent);
                 border: 1px solid var(--border); }
  button.danger { background: var(--err); }
  button:disabled { opacity: .45; cursor: default; }
  select, input[type=text], input[type=number], textarea {
    font: inherit; color: var(--fg); background: var(--bg);
    border: 1px solid var(--border); border-radius: 7px; padding: 6px 8px;
  }
  textarea { width: 100%; min-height: 56px; }
  progress { width: 120px; height: 8px; }
  .dot { width: 9px; height: 9px; border-radius: 50%;
         display: inline-block; background: var(--muted); }
  .dot.recording { background: var(--err);
                   animation: blink 1s step-start infinite; }
  .dot.processing { background: var(--accent); }
  .dot.done { background: var(--ok); }
  @keyframes blink { 50% { opacity: .25; } }
  #transcript { white-space: pre-wrap; min-height: 40px; }
  #events { max-height: 160px; overflow-y: auto; font-family: monospace;
            font-size: 12px; }
  .pill { border: 1px solid var(--border); border-radius: 99px;
          padding: 1px 9px; font-size: 12px; color: var(--muted); }
</style>
</head>
<body>
<main>
  <h1>nobs-whisper-torch <span id="health" class="pill">…</span></h1>

  <h2>Session</h2>
  <div class="card">
    <div class="row">
      <span id="state-dot" class="dot"></span>
      <span id="session-state" class="grow muted">no session</span>
      <button id="btn-new">New session</button>
      <button id="btn-toggle" disabled>Record</button>
      <button id="btn-cancel" class="ghost" disabled>Cancel (ESC)</button>
    </div>
    <h2>Transcript</h2>
    <div id="transcript" class="muted">—</div>
    <details><summary class="muted">events</summary>
      <div id="events"></div></details>
  </div>

  <h2>Settings</h2>
  <div class="card" id="config-card">
    <div class="row" style="flex-wrap:wrap">
      <label>Language
        <select id="cfg-language">
          <option value="auto">Auto-detect</option>
          <option value="ko">Korean</option><option value="en">English</option>
          <option value="ja">Japanese</option><option value="zh">Chinese</option>
          <option value="es">Spanish</option><option value="fr">French</option>
          <option value="de">German</option>
        </select></label>
      <label>Mode
        <select id="cfg-ptt">
          <option value="false">Toggle</option>
          <option value="true">Push-to-talk</option>
        </select></label>
      <label>Max s <input id="cfg-maxdur" type="number" min="0" max="600"
                          style="width:70px"></label>
      <label>Beam <input id="cfg-beam" type="number" min="1" max="8"
                         style="width:56px"></label>
      <label>Task
        <select id="cfg-task">
          <option value="transcribe">Transcribe</option>
          <option value="translate">Translate</option>
        </select></label>
    </div>
    <p class="muted" style="margin:10px 0 4px">Custom vocabulary
      (biases recognition toward these terms)</p>
    <textarea id="cfg-vocab"></textarea>
    <p class="muted" id="cfg-status"></p>
  </div>

  <h2>Models</h2>
  <div id="models"></div>
</main>
<script>
"use strict";
const $ = (id) => document.getElementById(id);
const j = async (url, opts) => {
  const r = await fetch(url, opts);
  if (!r.ok) throw new Error(url + ": " + r.status);
  return r.json();
};

// ---- health ---------------------------------------------------------
async function refreshHealth() {
  try {
    const h = await j("/health");
    $("health").textContent = h.loaded
      ? "model loaded" : "no model loaded";
  } catch (e) { $("health").textContent = "offline"; }
}

// ---- config (written through on change, +page.svelte:158-167) -------
let cfg = null;
async function loadConfig() {
  cfg = await j("/config");
  $("cfg-language").value = cfg.language || "auto";
  $("cfg-ptt").value = String(!!cfg.push_to_talk);
  $("cfg-maxdur").value = cfg.max_recording_duration;
  $("cfg-beam").value = cfg.beam_size || 1;
  $("cfg-task").value = cfg.task || "transcribe";
  $("cfg-vocab").value = cfg.custom_vocabulary || "";
}
let cfgQ = Promise.resolve();   // serialize write-throughs: POST /config
                                // is full-document (reference semantics,
                                // config.rs:115), so out-of-order
                                // responses would revert newer changes
async function saveConfig(patch) {
  cfg = Object.assign({}, cfg, patch);
  const doc = cfg;
  cfgQ = cfgQ.then(async () => {
    cfg = await j("/config", {method: "POST", body: JSON.stringify(doc)});
    $("cfg-status").textContent = "saved";
    setTimeout(() => $("cfg-status").textContent = "", 1200);
  }).catch((e) => { $("cfg-status").textContent = "save failed: " + e; });
  return cfgQ;
}
$("cfg-language").onchange = (e) => saveConfig({language: e.target.value});
$("cfg-ptt").onchange = (e) =>
  saveConfig({push_to_talk: e.target.value === "true"});
$("cfg-maxdur").onchange = (e) =>
  saveConfig({max_recording_duration: +e.target.value});
$("cfg-beam").onchange = (e) => saveConfig({beam_size: +e.target.value});
$("cfg-task").onchange = (e) => saveConfig({task: e.target.value});
$("cfg-vocab").onchange = (e) =>
  saveConfig({custom_vocabulary: e.target.value});

// ---- models (grouped, progress polled at 500 ms like the reference) --
const downloading = new Set();
const polling = new Set();      // one poll loop per model, ever
const dlErrors = {};            // last failure per model id
async function renderModels() {
  const models = await j("/models");
  const byCat = {};
  for (const m of models) (byCat[m.category] ||= []).push(m);
  const root = $("models");
  root.innerHTML = "";
  for (const [cat, list] of Object.entries(byCat)) {
    const h = document.createElement("h2");
    h.textContent = cat;
    root.appendChild(h);
    for (const m of list) {
      const d = document.createElement("div");
      d.className = "card row";
      const sel = cfg && cfg.selected_model === m.id;
      d.innerHTML =
        `<div class="grow"><b>${m.name || m.id}</b>` +
        (sel ? ` <span class="pill">selected</span>` : "") +
        `<div class="muted">${m.size || ""} — ${m.description || ""}</div>` +
        (dlErrors[m.id]
          ? `<div class="muted">download failed: ${dlErrors[m.id]}</div>`
          : "") +
        `<progress id="prog-${m.id}" max="100" value="0" hidden></progress>` +
        `</div>`;
      const btn = document.createElement("button");
      if (m.status === "downloaded") {
        btn.textContent = sel ? "Selected" : "Select";
        btn.disabled = sel;
        btn.onclick = async () => {
          await saveConfig({selected_model: m.id}); renderModels();
        };
        const del = document.createElement("button");
        del.className = "danger"; del.textContent = "Delete";
        del.onclick = async () => {
          await fetch(`/models/${m.id}`, {method: "DELETE"});
          renderModels();
        };
        d.appendChild(btn); d.appendChild(del);
      } else {
        btn.textContent = m.status === "downloading"
          ? "Downloading…" : "Download";
        btn.disabled = m.status === "downloading";
        btn.onclick = async () => {
          delete dlErrors[m.id];
          await j(`/models/${m.id}/download`, {method: "POST"});
          downloading.add(m.id);
          btn.disabled = true; btn.textContent = "Downloading…";
          pollProgress(m.id);
        };
        if (m.status === "downloading") {
          downloading.add(m.id); pollProgress(m.id);
        }
        d.appendChild(btn);
      }
      root.appendChild(d);
    }
  }
}
function pollProgress(id) {         // 500 ms, +page.svelte:106-119 analog
  if (polling.has(id)) return;      // renderModels re-runs must not
  polling.add(id);                  // stack extra poll loops
  const bar = () => $(`prog-${id}`);
  const tick = async () => {
    if (!downloading.has(id)) { polling.delete(id); return; }
    let p;
    try {
      p = await j(`/models/${id}/progress`);
    } catch (e) {                   // transient fetch failure: keep
      setTimeout(tick, 1000);       // polling, never strand the button
      return;
    }
    if (bar()) {
      bar().hidden = false;
      bar().value = p.progress == null ? 100 : p.progress;
    }
    if (p.progress == null) {       // finished or failed: re-list
      if (p.error) dlErrors[id] = p.error;
      downloading.delete(id);
      polling.delete(id);
      renderModels();
      return;
    }
    setTimeout(tick, 500);
  };
  setTimeout(tick, 500);
}

// ---- session panel (SSE = the indicator analog) ---------------------
let sid = null, recording = false, es = null;

// best-effort browser mic capture (the cpal-callback analog,
// state.rs:585-607): f32 PCM frames POSTed to the session's audio verb.
// Without a mic (or denied permission) the session verbs still work;
// stop just returns an empty transcript.
let mic = {ctx: null, node: null, stream: null, rate: 16000};
async function micInit() {
  if (mic.ctx || !navigator.mediaDevices) return;
  try {
    mic.stream = await navigator.mediaDevices.getUserMedia({audio: true});
    mic.ctx = new AudioContext();
    mic.rate = mic.ctx.sampleRate;
  } catch (e) { /* no mic: server-driven sessions still function */ }
}
let audioQ = Promise.resolve();   // chain PCM POSTs: parallel fetches
                                  // can arrive out of order and the
                                  // buffer appends in arrival order
function micStart() {
  if (!mic.ctx) return;
  const src = mic.ctx.createMediaStreamSource(mic.stream);
  const node = mic.ctx.createScriptProcessor(4096, 1, 1);
  node.onaudioprocess = (e) => {
    if (!recording) return;
    const body = new Float32Array(e.inputBuffer.getChannelData(0)).buffer;
    const target = sid;
    audioQ = audioQ
      .then(() => fetch(`/sessions/${target}/audio`,
                        {method: "POST", body}))
      .catch(() => {});             // a dropped chunk must not break
  };                                // the chain for later ones
  src.connect(node);
  node.connect(mic.ctx.destination);
  mic.node = {src, node};
}
function micStop() {
  if (mic.node) {
    mic.node.src.disconnect(); mic.node.node.disconnect();
    mic.node = null;
  }
}
function setState(s) {
  $("session-state").textContent = sid ? `${sid}: ${s}` : "no session";
  $("state-dot").className = "dot " + s;
  $("btn-toggle").disabled = !sid;
  $("btn-cancel").disabled = !sid;
  $("btn-toggle").textContent = recording ? "Stop" : "Record";
}
function logEvent(ev) {
  const line = document.createElement("div");
  line.textContent = JSON.stringify(ev);
  $("events").prepend(line);
}
$("btn-new").onclick = async () => {
  if (es) es.close();
  micStop();                        // or the old node keeps POSTing
  recording = false;
  if (sid) {                        // tear the old session down server-
    const old = sid;                // side instead of leaking it in
    sid = null;                     // RECORDING state
    try { await fetch(`/sessions/${old}/cancel`, {method: "POST"}); }
    catch (e) {}
    try { await fetch(`/sessions/${old}`, {method: "DELETE"}); }
    catch (e) {}
  }
  await micInit();
  const body = {sample_rate: mic.rate};
  if (cfg && cfg.language && cfg.language !== "auto")
    body.language = cfg.language;
  if (cfg && cfg.custom_vocabulary) body.vocabulary = cfg.custom_vocabulary;
  if (cfg && cfg.beam_size > 1) body.beam_size = cfg.beam_size;
  sid = (await j("/sessions", {method: "POST",
                               body: JSON.stringify(body)})).session;
  recording = false;
  setState("idle");
  es = new EventSource(`/sessions/${sid}/events`);
  es.onmessage = (m) => {
    const ev = JSON.parse(m.data);
    logEvent(ev);
    if (ev.state === "partial" && ev.transcript)
      $("transcript").textContent = ev.transcript;
    if (ev.is_final) {
      $("transcript").textContent = ev.transcript || "(empty)";
      recording = false; setState("done");
    } else if (ev.state === "cancelled") {
      recording = false; setState("idle");
    } else if (["recording", "processing"].includes(ev.state)) {
      recording = ev.state === "recording"; setState(ev.state);
    }
  };
};
$("btn-toggle").onclick = async () => {
  const out = await j(`/sessions/${sid}/toggle`, {method: "POST"});
  recording = !!out.recording;
  if (recording) micStart(); else micStop();
  setState(out.state);
};
$("btn-cancel").onclick = async () => {
  await j(`/sessions/${sid}/cancel`, {method: "POST"});
  recording = false; micStop(); setState("idle");
};
document.addEventListener("keydown", (e) => {   // ESC cancel analog
  if (e.key === "Escape" && sid) $("btn-cancel").onclick();
});

refreshHealth();
loadConfig().then(renderModels);
</script>
</body>
</html>
"""
