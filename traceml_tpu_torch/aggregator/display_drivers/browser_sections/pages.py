"""Page assembly: the layout that places the section cards, and the
client that feeds them.

Counterpart of ``.../browser_sections/pages.py``.  ``build_page()``
stitches the theme CSS, every section's static HTML (glass cards, step
time first), the shared JS helpers, each section's render function and a
delta client: payload fragments arrive over SSE (``/api/stream``), with
a ``?since=`` token polling fallback in ``tick()``, merge into one
payload object, and fan out to every section through ``renderAll()``.
The wordmark and the title name the port as its text report and CLI
header do, "TraceML (PyTorch)" (JAX: "TraceML-TPU"), and the run
context counts GPUs (JAX: chips).
"""

from __future__ import annotations

from typing import List

from traceml_tpu_torch.aggregator.display_drivers.browser_sections import (
    Section,
    render_call,
)
from traceml_tpu_torch.aggregator.display_drivers.browser_sections import theme
from traceml_tpu_torch.aggregator.display_drivers.browser_sections.cluster import (
    SECTION as CLUSTER,
)
from traceml_tpu_torch.aggregator.display_drivers.browser_sections.diagnostics import (
    SECTION as DIAGNOSTICS,
)
from traceml_tpu_torch.aggregator.display_drivers.browser_sections.hero import (
    SECTION as HERO,
)
from traceml_tpu_torch.aggregator.display_drivers.browser_sections.memory import (
    SECTION as MEMORY,
)
from traceml_tpu_torch.aggregator.display_drivers.browser_sections.process import (
    SECTION as PROCESS,
)
from traceml_tpu_torch.aggregator.display_drivers.browser_sections.step_time import (
    SECTION as STEP_TIME,
)
from traceml_tpu_torch.aggregator.display_drivers.browser_sections.summary import (
    OUTPUT_SECTION as OUTPUT,
)
from traceml_tpu_torch.aggregator.display_drivers.browser_sections.summary import (
    SECTION as SUMMARY,
)
from traceml_tpu_torch.aggregator.display_drivers.browser_sections.system import (
    GAUGE_SECTION as GAUGE,
)
from traceml_tpu_torch.aggregator.display_drivers.browser_sections.system import (
    SECTION as SYSTEM,
)

#: every section on the page, in render order (contract tests iterate this)
ALL_SECTIONS: List[Section] = [
    SUMMARY, HERO, GAUGE, STEP_TIME, DIAGNOSTICS,
    MEMORY, PROCESS, SYSTEM, CLUSTER, OUTPUT,
]

_HEADER = """
<div class="card reveal" style="padding:13px 20px">
  <div style="display:flex;align-items:center;gap:14px;flex-wrap:wrap">
    <span class="wm">TraceML <b>(PyTorch)</b></span>
    <span class="eyebrow">live training</span>
    <span class="cmeta" id="runctx"></span>
    <span style="flex:1"></span>
    <span class="muted" id="meta">connecting…</span>
    <span class="livedot"></span>
  </div>
</div>
"""


def _card(section: Section, reveal: str = "reveal") -> str:
    return f'<div class="card {reveal}">{section.html}</div>'


def _cell(inner: str, flex: str) -> str:
    return f'<div class="cell" style="flex:{flex}">{inner}</div>'


def build_page() -> str:
    body = [
        '<div class="wrap">',
        _HEADER,
        SUMMARY.html,  # a self-styled card; hidden until the run finalizes
        '<div class="grid">',
        _cell(_card(HERO, "reveal d1"), "2.4"),
        _cell(_card(GAUGE, "reveal d1"), "1"),
        "</div>",
        '<div class="grid">',
        _cell(_card(STEP_TIME, "reveal d2"), "2"),
        _cell(_card(DIAGNOSTICS, "reveal d2"), "1.3"),
        "</div>",
        '<div class="grid">',
        _cell(_card(MEMORY, "reveal d3"), "1.3"),
        _cell(_card(PROCESS, "reveal d3"), "1"),
        "</div>",
        _card(SYSTEM, "reveal d3"),
        _card(CLUSTER, "reveal d3"),
        _card(OUTPUT, "reveal d3"),
        "</div>",
        '<div id="tip"></div>',
    ]
    # sections with no JS of their own (the gauge) are driven by another
    # section's render fn — one subscriber per payload, like the ref
    calls = "".join(render_call(s) for s in ALL_SECTIONS if s.js)
    scripts = "\n".join(s.js for s in ALL_SECTIONS if s.js)
    js = f"""
{theme.HELPERS_JS}
{scripts}
function runContext(d){{
  const bits=[];
  const st=d.step_time;
  if(st&&st.coverage&&st.coverage.world_size)
    bits.push(`world ${{esc(st.coverage.world_size)}}`);
  const s=d.system;
  if(s&&s.nodes&&s.nodes.length){{
    const devs=s.nodes.reduce((a,n)=>a+(n.devices||[]).length,0);
    if(devs)bits.push(`${{esc(devs)}} GPU${{devs>1?"s":""}}`);
    bits.push(String(s.nodes[0].hostname).split(".")[0])}}
  document.getElementById("runctx").textContent=bits.join(" · ")}}
function renderAll(d){{
  const meta=document.getElementById("meta");
  meta.textContent=
    `session ${{d.session}} · updated ${{new Date(d.ts*1000).toLocaleTimeString()}}`;
  meta.className="muted";
  runContext(d);
  {calls}
}}
// delta client: D is the merged payload, TOKEN the server's version
// token. Fragments arrive over SSE (preferred) or the ?since= polling
// fallback; either way each delta merges fragment keys into D and
// re-renders — same render fns, fed incrementally.
let D=null,TOKEN=null,SSE_OK=false;
const SESSION=new URLSearchParams(location.search).get("session");
function api(p){{
  return SESSION?p+(p.indexOf("?")>=0?"&":"?")+
    "session="+encodeURIComponent(SESSION):p}}
function applyDelta(m){{
  if(!D)D={{}};
  for(const k in m.fragments)Object.assign(D,m.fragments[k]);
  D.ts=m.ts;TOKEN=m.token;
  renderAll(D);
}}
function startStream(){{
  if(!window.EventSource)return;
  const es=new EventSource(api("/api/stream"));
  es.addEventListener("fragment",ev=>{{SSE_OK=true;
    try{{applyDelta(JSON.parse(ev.data))}}catch(e){{}}}});
  es.addEventListener("hb",()=>{{SSE_OK=true}});
  es.onerror=()=>{{SSE_OK=false}};
}}
async function tick(){{
 try{{
  if(!SSE_OK){{
    const r=await fetch(TOKEN?api("/api/live?since="+
      encodeURIComponent(TOKEN)):api("/api/live"));
    if(r.status===200){{
      const m=await r.json();
      if(m.fragments)applyDelta(m);
      else{{D=m;TOKEN=r.headers.get("X-TraceML-Token");renderAll(D)}}
    }}
  }}
 }}catch(e){{const meta=document.getElementById("meta");
   meta.textContent="poll failed: "+e;meta.className="err"}}
 setTimeout(tick,1000);
}}
startStream();
tick();
"""
    return (
        "<!doctype html><html><head><meta charset=\"utf-8\">\n"
        "<title>TraceML (PyTorch) live</title>\n"
        f"{theme.head()}\n</head><body>\n"
        + "\n".join(body)
        + f"\n<script>{js}</script></body></html>"
    )
