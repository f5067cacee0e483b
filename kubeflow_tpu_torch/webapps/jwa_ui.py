"""Jupyter-web-app frontend: the notebook spawner UI.

Port of `kubeflow_tpu/webapps/jwa_ui.py`: the same page, its
accelerator select offering GPUs (`config.gpu`) where the JAX package's
offers TPU chips.

The reference JWA ships an Angular/JS frontend (jupyter-web-app/frontend)
over its Flask backend; this is the same spawner as one dependency-free
page served by the backend itself:

- create form: name / image / cpu / memory / GPUs (the utils.py:262
  GPU point, surfaced in the UI)
- workspace volume section: none | create new | attach existing PVC
  (PVC list from /api/namespaces/{ns}/pvcs, like the reference's
  volume form)
- configurations: PodDefault multi-select; selected entries' selector
  matchLabels are applied to the notebook so the admission webhook
  injects them (spawner_ui_config.yaml "configurations" analogue)
- notebook table: status, image, connect link, stop/start toggle
  (the culler's stop annotation) and delete, plus last event per row
"""

from __future__ import annotations

from kubeflow_tpu_torch.utils.httpd import HttpReq, HttpResp

PAGE = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>Notebooks — kubeflow-tpu</title>
<style>
  body { font-family: system-ui, sans-serif; margin: 0; background: #f5f6f8; }
  header { background: #1a73e8; color: #fff; padding: 10px 20px;
           display: flex; gap: 16px; align-items: center; }
  header h1 { font-size: 18px; margin: 0; flex: 1; }
  main { max-width: 1000px; margin: 20px auto; display: grid; gap: 16px; }
  .card { background: #fff; border-radius: 8px; padding: 16px;
          box-shadow: 0 1px 3px rgba(0,0,0,.15); }
  table { width: 100%; border-collapse: collapse; font-size: 14px; }
  th, td { text-align: left; padding: 6px 8px; border-bottom: 1px solid #eee; }
  select, input, button { font-size: 14px; padding: 6px 8px; margin: 2px 0;
                          border: 1px solid #ccc; border-radius: 4px; }
  button { cursor: pointer; background: #fff; }
  .primary { background: #1a73e8; color: #fff; border: none; }
  .muted { color: #777; font-size: 12px; }
  form { display: grid; grid-template-columns: repeat(3, 1fr); gap: 8px; }
  form label { display: flex; flex-direction: column; font-size: 12px;
               color: #555; }
  fieldset { grid-column: 1 / -1; border: 1px solid #eee; border-radius: 6px;
             display: grid; grid-template-columns: repeat(3, 1fr); gap: 8px; }
  fieldset legend { font-size: 12px; color: #555; padding: 0 4px; }
  .cfg { display: flex; gap: 6px; align-items: center; font-size: 13px; }
  .ev { font-size: 11px; color: #777; }
</style>
</head>
<body>
<header>
  <h1>Notebooks</h1>
  <select id="ns"></select>
</header>
<main>
  <div class="card">
    <h2>New notebook</h2>
    <form id="spawn">
      <label>Name <input name="name" required></label>
      <label>Image <select name="image" id="images"></select></label>
      <label>GPUs <select name="gpu" id="gpus"></select></label>
      <label>CPU <input name="cpu" value="0.5"></label>
      <label>Memory <input name="memory" value="1Gi"></label>
      <label>&nbsp;</label>
      <fieldset>
        <legend>Workspace volume</legend>
        <label>Mode
          <select id="vol-mode">
            <option value="none">none</option>
            <option value="new">create new</option>
            <option value="existing">attach existing</option>
          </select>
        </label>
        <label id="vol-new" style="display:none">Size
          <input id="vol-size" value="10Gi"></label>
        <label id="vol-existing" style="display:none">PVC
          <select id="pvcs"></select></label>
        <label>Mount path <input id="vol-mount" value="/home/jovyan"></label>
      </fieldset>
      <fieldset>
        <legend>Configurations (PodDefaults)</legend>
        <div id="poddefaults" class="cfg muted" style="grid-column:1/-1">
          none available in this namespace</div>
      </fieldset>
      <label style="grid-column:1/-1">
        <button class="primary" type="submit">Launch</button></label>
    </form>
    <p class="muted" id="msg"></p>
  </div>
  <div class="card">
    <h2>Running</h2>
    <table>
      <thead><tr><th>Name</th><th>Status</th><th>Image</th>
        <th>Last event</th><th></th></tr></thead>
      <tbody id="list"><tr><td class="muted" colspan="5">loading</td></tr></tbody>
    </table>
  </div>
</main>
<script>
const $ = (id) => document.getElementById(id);
const api = (p, opt) => fetch(p, opt).then(r => {
  if (!r.ok) throw new Error('HTTP ' + r.status);
  return r.json();
});

let config = {};
let podDefaults = [];

async function init() {
  config = (await api('api/config')).config || {};
  for (const img of (config.image?.options || [])) {
    const o = document.createElement('option');
    o.value = o.textContent = img;
    $('images').appendChild(o);
  }
  for (const n of (config.gpu?.options || [0])) {
    const o = document.createElement('option');
    o.value = o.textContent = n;
    $('gpus').appendChild(o);
  }
  const nss = (await api('api/namespaces')).namespaces || [];
  for (const ns of nss) {
    const o = document.createElement('option');
    o.value = o.textContent = ns;
    $('ns').appendChild(o);
  }
  if (nss.length) await nsChanged();
}

async function nsChanged() {
  const ns = $('ns').value;
  await Promise.all([refresh(), loadPvcs(ns), loadPodDefaults(ns)]);
}

async function loadPvcs(ns) {
  const out = await api('api/namespaces/' + ns + '/pvcs').catch(() => ({pvcs: []}));
  const sel = $('pvcs');
  sel.innerHTML = '';
  for (const p of out.pvcs || []) {
    const o = document.createElement('option');
    o.value = p.name;
    o.textContent = p.name + (p.size ? ' (' + p.size + ')' : '');
    sel.appendChild(o);
  }
}

async function loadPodDefaults(ns) {
  const out = await api('api/namespaces/' + ns + '/poddefaults')
    .catch(() => ({poddefaults: []}));
  podDefaults = out.poddefaults || [];
  const box = $('poddefaults');
  box.innerHTML = '';
  for (const pd of podDefaults) {
    const row = document.createElement('label');
    row.className = 'cfg';
    const cb = document.createElement('input');
    cb.type = 'checkbox';
    cb.value = pd.name;
    row.appendChild(cb);
    row.appendChild(document.createTextNode(pd.desc || pd.name));
    box.appendChild(row);
  }
  if (!podDefaults.length) {
    box.textContent = 'none available in this namespace';
    box.className = 'cfg muted';
  } else {
    box.className = 'cfg';
  }
}

$('vol-mode').addEventListener('change', () => {
  const m = $('vol-mode').value;
  $('vol-new').style.display = m === 'new' ? '' : 'none';
  $('vol-existing').style.display = m === 'existing' ? '' : 'none';
});

async function refresh() {
  const ns = $('ns').value;
  const out = await api('api/namespaces/' + ns + '/notebooks');
  const tb = $('list');
  tb.innerHTML = '';
  for (const nb of out.notebooks || []) {
    // DOM-built rows: names/images are never interpolated into HTML
    const tr = document.createElement('tr');
    const lastEv = (nb.events || []).slice(-1)[0];
    for (const text of [nb.name, (nb.status && nb.status.phase) || 'unknown',
                        nb.image || '']) {
      const td = document.createElement('td');
      td.textContent = text;
      tr.appendChild(td);
    }
    const ev = document.createElement('td');
    ev.className = 'ev';
    ev.textContent = lastEv ? (lastEv.reason + ': ' + lastEv.message) : '';
    tr.appendChild(ev);
    const td = document.createElement('td');
    const a = document.createElement('a');
    a.href = '/notebook/' + encodeURIComponent(ns) + '/' +
             encodeURIComponent(nb.name) + '/';
    a.textContent = 'connect';
    const stopped = nb.status && nb.status.phase === 'stopped';
    const toggle = document.createElement('button');
    toggle.textContent = stopped ? 'start' : 'stop';
    toggle.addEventListener('click', async () => {
      await fetch('api/namespaces/' + encodeURIComponent(ns) +
                  '/notebooks/' + encodeURIComponent(nb.name), {
        method: 'PATCH',
        headers: {'Content-Type': 'application/json'},
        body: JSON.stringify({stopped: !stopped}),
      });
      refresh();
    });
    const del = document.createElement('button');
    del.textContent = 'delete';
    del.addEventListener('click', async () => {
      await fetch('api/namespaces/' + encodeURIComponent(ns) +
                  '/notebooks/' + encodeURIComponent(nb.name),
                  {method: 'DELETE'});
      refresh();
    });
    td.append(a, ' ', toggle, ' ', del);
    tr.appendChild(td);
    tb.appendChild(tr);
  }
  if (!tb.children.length)
    tb.innerHTML = '<tr><td class="muted" colspan="5">none</td></tr>';
}

$('ns').addEventListener('change', nsChanged);
$('spawn').addEventListener('submit', async (e) => {
  e.preventDefault();
  const ns = $('ns').value;
  const form = Object.fromEntries(new FormData(e.target).entries());
  form.gpu = parseInt(form.gpu || '0', 10);
  const mode = $('vol-mode').value;
  if (mode === 'new') {
    // create the PVC first, then attach (reference post_pvc flow);
    // 409 = claim already exists from an earlier attempt -> reuse it,
    // any other failure aborts so the notebook never mounts a missing
    // claim
    const claim = 'workspace-' + form.name;
    const pr = await fetch('api/namespaces/' + ns + '/pvcs', {
      method: 'POST', headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({name: claim, size: $('vol-size').value}),
    });
    if (!pr.ok && pr.status !== 409) {
      $('msg').textContent = 'volume create failed: HTTP ' + pr.status;
      return;
    }
    form.workspaceVolume = {name: claim, mountPath: $('vol-mount').value};
  } else if (mode === 'existing') {
    if (!$('pvcs').value) {
      $('msg').textContent = 'no existing volume to attach in this namespace';
      return;
    }
    form.workspaceVolume = {name: $('pvcs').value,
                            mountPath: $('vol-mount').value};
  }
  // configurations -> labels matching the PodDefault selectors
  const labels = {};
  document.querySelectorAll('#poddefaults input:checked').forEach(cb => {
    const pd = podDefaults.find(p => p.name === cb.value);
    Object.assign(labels, (pd && pd.matchLabels) || {});
  });
  if (Object.keys(labels).length) form.labels = labels;
  const r = await fetch('api/namespaces/' + ns + '/notebooks', {
    method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify(form),
  });
  $('msg').textContent = r.ok ? 'created' : 'failed: HTTP ' + r.status;
  if (r.ok) refresh();
});

init().catch(e => { $('msg').textContent = String(e); });
setInterval(() => refresh().catch(() => {}), 10000);
</script>
</body>
</html>
"""


def page(req: HttpReq) -> HttpResp:
    return HttpResp(200, PAGE.encode(), "text/html")


def add_ui_routes(router) -> None:
    router.route("GET", "/", page)
    router.route("GET", "/spawner", page)
